from free_hunch_tpu_torch.guidance.mechanisms import (  # noqa: F401
    DPS, TMPD, DiffPIR, FreeHunch, FreeHunchState, PengAnalytic, PengConvert, PiGDM,
    PiGDMVideodiffSchedule, choose_conditioning_mechanism,
)
