"""Training-side modules of the port: the step, the train state, the
flat layout, checkpoints, metrics, callbacks, ``Module`` and ``Trainer``."""
