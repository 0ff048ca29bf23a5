"""The plain references: one module per family of templates, one function
per template, in plain PyTorch over the generated tensors. They import
nothing of the port and nothing of JAX."""
