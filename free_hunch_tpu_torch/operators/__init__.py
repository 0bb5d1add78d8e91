from free_hunch_tpu_torch.operators.linear import (  # noqa: F401
    LinearOperator, get_operator, register_operator,
)
from free_hunch_tpu_torch.operators.noise import get_noise, register_noise  # noqa: F401
