"""The plain reference that decides `correct`: WaveNet (arXiv 1609.03499)
in plain PyTorch, float32 with TF32 off, and what it needs to judge the
port's outputs (mu-law, the training windows' draw, Adam, the sampler's
counter noise), each worked out again by its own code.  It imports nothing
of the port, of JAX or of the JAX package.
"""
