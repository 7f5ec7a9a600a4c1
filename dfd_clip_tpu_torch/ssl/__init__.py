"""DINOv2-style self-supervised pretraining and its evaluation suite
(counterpart of dfd_clip_tpu/ssl/): student and teacher DINOv2 towers with
the DINO, iBOT and KoLeo objectives, cosine schedules with layerwise
learning-rate decay, sharded infinite samplers, host-side multi-crop
augmentation and block masks, and the kNN / linear / logistic-regression
evaluations. The training CLI is ``dfd_clip_tpu_torch.ssl_train``, the
evaluation CLI ``dfd_clip_tpu_torch.ssl_eval``.
"""

from .train import SSLTrainer

__all__ = ["SSLTrainer"]
