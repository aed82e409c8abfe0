"""Continuous-batching serving over a paged KV pool."""
