"""The text functions of the JAX app (``rag_foundation_tpu.app``) that the
generative decoder's trainer (``tools/train_decoder``) needs, copied so
that it runs where JAX is not installed: the span-reader cascade that
labels its examples (``services.rag.compose_answer`` over
``services.reader`` and ``services.textnorm``), the evidence of its
prompts (``services.generator.prep_evidence``) and the refusal text. The
app itself (HTTP/SSE server, stores, chat) stays in the JAX package and
reaches the port's engine over its RPC socket.
"""
