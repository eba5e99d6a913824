"""PARSeq tokenizer: charset <-> ids, greedy decode (the port's copy of
yomitoku_tpu/postprocessor/parseq_tokenizer.py).

Specials: EOS first (id 0), then the charset, then BOS and PAD last;
decoding truncates at the first EOS and the sequence probability is the
product of the per-token probabilities up to and including EOS.
"""

import numpy as np


class BaseTokenizer:
    def __init__(self, charset: str, specials_first=(), specials_last=()):
        self._itos = specials_first + tuple(charset) + specials_last
        self._stoi = {s: i for i, s in enumerate(self._itos)}

    def __len__(self):
        return len(self._itos)

    def _tok2ids(self, tokens: str):
        return [self._stoi[s] for s in tokens]

    def _ids2tok(self, token_ids, join: bool = True):
        tokens = [self._itos[int(i)] for i in token_ids]
        return "".join(tokens) if join else tokens

    def decode(self, token_dists, raw: bool = False):
        """token_dists: (B, L, C) softmax probabilities (ndarray).

        Returns (list of strings, list of float sequence probabilities).
        """
        dists = np.asarray(token_dists)
        ids = dists.argmax(-1)  # (B, L)
        probs = np.take_along_axis(dists, ids[..., None], axis=-1)[..., 0]  # (B, L)
        return self.decode_ids(ids, probs, raw=raw)

    def decode_ids(self, ids, probs, raw: bool = False):
        """Decode pre-reduced greedy (ids, probs) (B, L) arrays — the
        device-side reduction path (models compute argmax on device so only
        two small arrays cross the host boundary)."""
        ids, probs = np.asarray(ids), np.asarray(probs)
        batch_tokens, batch_probs = [], []
        for row_ids, row_probs in zip(ids, probs):
            if raw:
                batch_tokens.append(self._ids2tok(row_ids, False))
                batch_probs.append(float(row_probs.prod()))
                continue
            fprobs, fids = self._filter(row_probs, row_ids)
            batch_tokens.append(self._ids2tok(fids, True))
            batch_probs.append(float(np.prod(fprobs)))
        return batch_tokens, batch_probs

    def _filter(self, probs, ids):
        raise NotImplementedError

    def encode(self, labels):
        raise NotImplementedError


class ParseqTokenizer(BaseTokenizer):
    BOS = "[B]"
    EOS = "[E]"
    PAD = "[P]"

    def __init__(self, charset: str):
        specials_first = (self.EOS,)
        specials_last = (self.BOS, self.PAD)
        super().__init__(charset, specials_first, specials_last)
        self.eos_id = self._stoi[self.EOS]
        self.bos_id = self._stoi[self.BOS]
        self.pad_id = self._stoi[self.PAD]

    def encode(self, labels):
        """Labels -> (B, Lmax) int array padded with pad_id."""
        rows = [
            [self.bos_id] + self._tok2ids(y) + [self.eos_id] for y in labels
        ]
        width = max(len(r) for r in rows)
        out = np.full((len(rows), width), self.pad_id, dtype=np.int64)
        for i, r in enumerate(rows):
            out[i, : len(r)] = r
        return out

    def _filter(self, probs, ids):
        eos_positions = np.nonzero(ids == self.eos_id)[0]
        eos_idx = int(eos_positions[0]) if len(eos_positions) else len(ids)
        # Truncate at EOS but keep its probability in the product.
        return probs[: eos_idx + 1], ids[:eos_idx]
