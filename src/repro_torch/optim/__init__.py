from .optimizers import (  # noqa: F401
    adafactor_init_specs,
    adamw_init_specs,
    cosine_schedule,
    make_optimizer,
)
