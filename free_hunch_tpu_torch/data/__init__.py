"""See the module docstrings; the layout mirrors free_hunch_tpu."""
