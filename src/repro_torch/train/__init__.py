"""Training: the step (``train_loop``), checkpoints (``checkpoint``) and the
supervisor with restarts (``fault_tolerance``)."""
