"""Training engine: optimizers and the learning-rate schedule, the step
Trainer and the CompInv adapter pretrainer, their evaluators, the callbacks
they fire, and train-state checkpoints."""

from .evaluator import CompInvEvaluator, Evaluator
from .trainer import CompInvTrainer, Trainer

__all__ = ["Trainer", "CompInvTrainer", "Evaluator", "CompInvEvaluator"]
