from .train_step import TrainState, make_train_state_specs, make_train_step  # noqa: F401
from .serve_step import make_decode_fn, make_prefill_fn, serve_param_specs  # noqa: F401
