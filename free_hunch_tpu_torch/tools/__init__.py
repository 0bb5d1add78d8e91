"""Command-line tools of the port, each run as ``python -m free_hunch_tpu_torch.tools.<name>``:
``count_flops``, ``dataset_tool``, ``frequency_analysis``, ``image_visualisation``,
``compute_fid_stats`` and ``convert_lpips_weights``."""
