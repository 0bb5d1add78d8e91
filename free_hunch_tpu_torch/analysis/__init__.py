"""Exact-posterior oracles (counterpart of ``free_hunch_tpu/analysis``)."""
