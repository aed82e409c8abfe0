"""Decoder model: layers, attention, MoE, the decoder stack."""
