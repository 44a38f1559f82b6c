"""Host control plane: the multi-tenant RAG web application on the port's
engine (counterpart of ``rag_foundation_tpu.app``).

The auth -> stores -> upload -> SSE chat path of the JAX app, copied where
it is stdlib Python and rebuilt where the JAX app leans on packages the
card machine lacks: ``Settings`` and the request models without pydantic
(``validation``), the Prometheus series without prometheus_client
(``metrics``). It runs on ``rag_foundation_tpu_torch.runtime`` and the
port's ``Engine`` (in process on the card, or over the engine RPC socket);
``python -m rag_foundation_tpu_torch.app.main`` serves it. The span-reader
text services (``services.rag``, ``services.reader``,
``services.textnorm``) also label the decoder trainer's examples
(``tools/train_decoder``).
"""
