"""Training engine: optimizers and the learning-rate schedule, the step
Trainer, the Evaluator, the callbacks both fire, and train-state
checkpoints."""
