"""Training of the port (counterpart of ``repro.training``): AdamW
(``optimizer``), the synthetic data (``data``), the plain and the robust
train steps (``train_step``), the activation probe (``probes``) and the
checkpoints that training and the segmented solves share
(``checkpoint``)."""
