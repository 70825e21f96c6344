from .train_step import (TrainState, jit_train_step, make_train_state_specs,  # noqa: F401
                         make_train_step)
from .serve_step import make_decode_fn, make_prefill_fn, serve_param_specs  # noqa: F401
