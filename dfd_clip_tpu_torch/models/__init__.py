"""The port's models: CLIP vision tower, temporal decoder, detector."""
