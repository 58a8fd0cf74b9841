"""Plain references of the benchmark's configurations, one module each,
named by a configuration's ``reference``. They import torch alone: nothing
of the program under test, nothing of JAX. Each module gives
``param_shapes(knobs)``, ``forward(params, ops, knobs, moving, fixed)`` and
``train_outputs(outputs)``."""
