"""Training engine: optimizers, learning-rate schedule and the step trainer."""
