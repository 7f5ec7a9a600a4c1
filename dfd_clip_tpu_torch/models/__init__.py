"""The port's models: CLIP vision, text and ResNet towers, temporal decoder,
detector, and the CompInv adapter pretrainer.

``Detector`` and ``CompInvEncoder`` resolve on first use (a module
``__getattr__``), so that importing one of the package's modules, such as
``models.layers`` from ``ops/``, does not import the detector and the ops
it pulls in."""

import importlib

_LAZY = {"Detector": ".detector", "CompInvEncoder": ".adapter"}

__all__ = ["Detector", "CompInvEncoder"]


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name], __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
