"""PyTorch and CUDA port of the DCF-PCA system (``repro`` is the JAX
reference).  Entry points run on the CUDA card unless ``device="cpu"`` is
passed; see ``repro_torch.rpca.solve``."""
