from free_hunch_tpu_torch.guidance.mechanisms import (  # noqa: F401
    FreeHunch, FreeHunchState, choose_conditioning_mechanism,
)
