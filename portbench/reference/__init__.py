"""The plain reference: PyTorch modules and attack loops written from the
published descriptions. It imports nothing of the program, of JAX or of the
JAX package, and takes nothing the program made."""
