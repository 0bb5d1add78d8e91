from free_hunch_tpu_torch.samplers.edm import (  # noqa: F401
    conditional_sampler, get_sigma_steps, prepare_schedule, required_cov_capacity, sample_loop,
)
