"""Speculative decoding, the fused round and the engine core."""
