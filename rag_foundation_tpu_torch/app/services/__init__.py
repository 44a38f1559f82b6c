"""JAX-free copies of the JAX app's answer-text services (see
``rag_foundation_tpu_torch.app``)."""
