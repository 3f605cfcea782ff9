"""Training-side utilities of the port: mid-solve checkpoints
(counterpart of ``repro.training.checkpoint``)."""
