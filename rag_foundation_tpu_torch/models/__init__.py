"""Models of the port: the feature-hashing encoder, the MiniLM encoder
(``encoder``, with ``tokenizer`` and ``vocab``), the hybrid of the two,
and the generative decoder (``decoder``, with ``gen_tokenizer``)."""

from rag_foundation_tpu_torch.models.decoder import (DecoderConfig,
                                                     TextGenerator,
                                                     load_decoder)
from rag_foundation_tpu_torch.models.gen_tokenizer import GenTokenizer

__all__ = ["DecoderConfig", "GenTokenizer", "TextGenerator", "load_decoder"]
