from free_hunch_tpu_torch.operators.linear import (  # noqa: F401
    LinearOperator, get_operator, register_operator,
)
