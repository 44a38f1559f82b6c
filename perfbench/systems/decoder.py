"""The system under test for ``mode: decoder``: the app's answer decoder
(``models/decoder.py``'s ``TextGenerator``, as ``Engine.generate_stream``
serves it), one request at a time through ``TextGenerator.stream``, the
serving loop itself: its prefill, its decode blocks of ``gen_block``
tokens and its constrained-decoding bias.

``stream`` takes a question and passages and encodes them with the
generator's tokenizer; here the tokenizer it sees hands it the request's
prompt ids as the encoded prompt, and each time ``stream`` turns the
answer's ids into text (after the prefill's token, and after each block)
the ids are on the host: the request is marked then, and the text is
decoded as the app decodes it. The logits are kept as ``stream``'s
prefill returns them. Two things differ from the app: EOS is banned in
the bias (every request decodes its whole budget, as the configuration
states, so the work does not depend on rounding), and while a
window is traced ``feed.span`` ranges wrap the prefill, the blocks and
the request.
"""

from __future__ import annotations

from rag_foundation_tpu_torch.models import decoder
from rag_foundation_tpu_torch.models.gen_tokenizer import EOS_ID

BANNED = -1e9


class _Generator(decoder.TextGenerator):
    """``TextGenerator`` whose constrained-decoding bias also bans EOS."""

    def vocab_bias(self, prompt_ids):
        bias = super().vocab_bias(prompt_ids)
        bias[EOS_ID] = BANNED
        return bias


class _Tokenizer:
    """The tokenizer ``stream`` sees while it serves ``req``."""

    def __init__(self, tokenizer):
        self.tokenizer = tokenizer
        self.req = None
        self.ids = None

    def encode_prompt(self, question, evidences, max_len):
        return self.req.ids.tolist()

    def decode(self, ids):
        self.req.emit(len(ids))
        self.ids = ids
        return self.tokenizer.decode(ids)


class Served:
    def __init__(self, cfg: dict, root, device):
        if not cfg["constrained"]:
            raise ValueError("the decoder adapter serves constrained "
                             "answers (EOS banned in their bias)")
        self.gen = _Generator(str(root / cfg["checkpoint"]),
                              block=cfg["gen_block"], constrained=True,
                              device=device)
        self.tok = _Tokenizer(self.gen.tokenizer)
        self.gen.tokenizer = self.tok
        self.widths = self.gen.cfg._asdict()
        self.logits = None

    def serve(self, feed) -> None:
        real_prefill, real_block = decoder.prefill, decoder.decode_block

        def prefill(*a, **kw):
            with feed.span("prefill"):
                cache, self.logits = real_prefill(*a, **kw)
            return cache, self.logits

        def decode_block(*a, **kw):
            with feed.span("decode_block"):
                return real_block(*a, **kw)

        decoder.prefill, decoder.decode_block = prefill, decode_block
        try:
            while (req := feed.take()) is not None:
                self.tok.req = req
                with feed.span("request"):
                    for _ in self.gen.stream("", [],
                                             max_tokens=req.max_tokens):
                        pass
                feed.finish(req, self.tok.ids, self.logits[0])
        finally:
            decoder.prefill, decoder.decode_block = real_prefill, real_block

    def free(self) -> None:
        del self.gen, self.tok, self.logits


def load(cfg: dict, root, device) -> Served:
    return Served(cfg, root, device)
