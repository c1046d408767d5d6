"""The plain references that decide ``correct``: plain PyTorch from each
configuration's file, independent of the program (they import nothing of
``wsss_tpu_torch``, of JAX or of the JAX package)."""
