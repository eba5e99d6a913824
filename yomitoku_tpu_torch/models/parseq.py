"""PARSeq scene-text recognizer (counterpart of
yomitoku_tpu/models/parseq.py).

ViT encoder over 32xW line crops, a two-stream transformer decoder,
greedy autoregressive decode with batch early exit and one cloze
refinement pass, then the greedy reduction to (ids, probs) on the device.

Where the JAX package runs the decode as one ``lax.while_loop`` program,
the port runs a Python loop of fixed-shape steps: a static token buffer,
content K/V caches written one row per step, the memory K/V projected
once before the loop, and an exit as soon as every row holds an EOS (one
device-to-host read of a flag per step).  On CUDA the depth-1 step is one
CUDA graph, captured on the first batch of each size and replayed.

Token ids follow the reference tokenizer: EOS=0, then the charset, then
BOS=num_tokens-2, PAD=num_tokens-1; the head predicts num_tokens-2
classes.

The AR loop's memory K/V may be held as an int8 cache with per-(batch,
head) scales (``int8_kv``), as in the JAX package: on by default on CUDA,
off on the CPU, YOMITOKU_TPU_INT8_KV=1/0 forces it, read once when the
model is built (the JAX package bakes it in at first trace).  The content
cache stays full precision.  ``audit_int8_kv`` checks one batch's greedy
ids against the full cache and turns int8 off on divergence.
"""

import math
import os
import threading

import numpy as np
import torch
from torch import nn

from ..utils.logger import set_logger
from ..utils.stagetrace import segment
from .base import TorchModel, trunc_normal_
from .layers.two_stream import TwoStreamDecoder
from .layers.vit import ViTEncoder

logger = set_logger(__name__, "INFO")


def _int8_kv_default(device) -> bool:
    """The int8 memory-K/V cache: on for CUDA, off on the CPU, where exact
    parity with the JAX package's f32 path is the point.
    YOMITOKU_TPU_INT8_KV=1/0 forces either way; other values keep the
    default.  Validated against the full cache on random weights only: a
    real-checkpoint load audits it (``PARSeq.audit_int8_kv``)."""
    env = os.environ.get("YOMITOKU_TPU_INT8_KV")
    if env in ("1", "true", "True"):
        return True
    if env in ("0", "false", "False"):
        return False
    return torch.device(device).type == "cuda"


_INT8_KV_NOTICED = False


def _notice_int8_kv_default():
    """One notice per process that the CUDA default quantizes the memory
    K/V cache; silent when the user chose (YOMITOKU_TPU_INT8_KV)."""
    global _INT8_KV_NOTICED
    if _INT8_KV_NOTICED or os.environ.get("YOMITOKU_TPU_INT8_KV"):
        return
    _INT8_KV_NOTICED = True
    logger.info(
        "PARSeq AR decode uses an int8 memory K/V cache (CUDA default). "
        "Real-checkpoint loads audit greedy parity against the full cache "
        "and fall back on divergence; set YOMITOKU_TPU_INT8_KV=0 to force "
        "the full cache.")


class TokenEmbedding(nn.Module):
    def __init__(self, num_tokens, embed_dim):
        super().__init__()
        self.embedding = nn.Embedding(num_tokens, embed_dim)
        self.scale = math.sqrt(embed_dim)

    def forward(self, tokens):
        # content embeddings are scaled by sqrt(D), the scale first rounded
        # to the compute dtype as the JAX package rounds it
        w = self.embedding.weight
        scale = torch.tensor(self.scale, dtype=torch.float32).to(w.dtype).item()
        return self.embedding(tokens) * scale


class _CachedARLoop:
    """The depth-1 AR loop for one batch size and memory length (the
    recognizer's width buckets give one canvas, and so one memory length,
    per bucket): fixed-shape buffers (token
    ids, content K/V caches, the memory K/V, the step counter and a
    ``done`` flag) and one step over them.  The memory K/V is f32, or with
    ``int8_kv`` int8 codes and per-(batch, head) f32 scales.

    A step reads its position from the device counter and gates every write
    on ``done``, so it needs no host value: on CUDA it is captured once as
    a CUDA graph, on the first batch of this shape, and replayed for every
    step of every later batch (the loop is otherwise bound by launching
    ~120 small ops per step from Python).  Each batch resets the buffers in
    place, so the graph's addresses stay valid; the graph also reads the
    model's parameters in place (loading a state_dict copies into them).
    The host reads ``done`` after each step to exit early; a step run after
    ``done`` would change nothing.

    The buffers and the graph are shared by every caller of the model, so
    a decode holds the model's ``_ar_lock`` from the reset to the clones it
    returns: pages decoded on several threads (DocumentAnalyzer.batch)
    take turns instead of writing into each other's buffers.  The capture
    runs under that lock in the "thread_local" capture mode, so the other
    threads' allocations and synchronisations (the detector's, the layout
    models') neither fail it nor are refused while it runs."""

    def __init__(self, model, B, L, causal, int8_kv):
        self.model = model
        self.int8_kv = int8_kv
        self.layer = layer = model.decoder.layers[0]
        self.L = L
        H = layer.self_attn.num_heads
        dh = layer.self_attn.embed_dim // H
        dev = causal.device
        self.causal = causal.clone()
        self.tgt_in = torch.empty((B, L), dtype=torch.long, device=dev)
        # The caches hold values of the compute dtype but are stored f32 and
        # contiguous per (batch, head): every step's attention takes f32
        # logits (as the JAX package's preferred_element_type does), and
        # this layout spares a full copy of the 400-row memory K/V per step.
        self.kc = torch.empty((B, H, L, dh), dtype=torch.float32, device=dev)
        self.vc = torch.empty_like(self.kc)
        # (km, vm) (B, H, M, dh) f32, or (kq, sk, vq, sv): int8 codes and
        # (B, H, 1, 1) f32 scales; allocated on the first batch
        self.mem = None
        self.logits = None
        if model.refine_iters == 0:
            self.logits = torch.empty(
                (B, L, model.num_tokens - 2), dtype=torch.float32, device=dev
            )
        self.pos_all = model.position_queries(B, L)
        self.step_i = torch.empty(1, dtype=torch.long, device=dev)
        self.done = torch.empty(1, dtype=torch.bool, device=dev)
        self.graph = None

    def _reset(self, memory):
        m = self.model
        if self.int8_kv:
            mem = self.layer.memory_kv_int8(memory)
        else:
            mem = self.layer.memory_kv(memory)
        if self.mem is None:
            self.mem = tuple(
                torch.empty(t.shape, device=t.device,
                            dtype=t.dtype if self.int8_kv else torch.float32)
                for t in mem)
        for dst, src in zip(self.mem, mem):
            dst.copy_(src)
        self.tgt_in.fill_(m.pad_id)
        self.tgt_in[:, 0] = m.bos_id
        self.kc.zero_()
        self.vc.zero_()
        bos = self.tgt_in[:, :1]
        kr, vr = self.layer.content_kv(m.content_embeddings(bos))
        self.kc[:, :, :1], self.vc[:, :, :1] = kr, vr
        if self.logits is not None:
            self.logits.zero_()
        self.step_i.zero_()
        self.done.zero_()

    def step(self):
        m, L = self.model, self.L
        i = self.step_i
        j = (i + 1).clamp(max=L - 1)  # the row this step writes
        live = ~self.done
        km, vm = (self.mem, None) if self.int8_kv else self.mem
        p_i = m.head(m.decoder.ar_query_step(
            self.pos_all.index_select(1, i), self.kc, self.vc, km, vm,
            self.causal.index_select(0, i),
        )).float()
        if self.logits is not None:
            self.logits.index_copy_(
                1, i, torch.where(live, p_i, self.logits.index_select(1, i))
            )
        nxt = p_i[:, 0].argmax(-1)
        write = live & (i + 1 < L)
        tgt_in = self.tgt_in
        tgt_in.index_copy_(
            1, j, torch.where(write, nxt, tgt_in.index_select(1, j)[:, 0])[:, None]
        )
        row = m.pos_queries.index_select(1, j - 1) + m.text_embed(nxt[:, None])
        kr, vr = self.layer.content_kv(row)
        self.kc.index_copy_(2, j, kr.float())
        self.vc.index_copy_(2, j, vr.float())
        # early exit once every row has produced an EOS
        self.done.logical_or_(write & (tgt_in == m.eos_id).any(-1).all())
        self.step_i.add_(1)

    def _capture(self):
        """Run step 0 on a side stream (the warm-up graph capture needs),
        then capture the step in a CUDA graph."""
        dev = self.tgt_in.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.step()
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.step()

    def __call__(self, memory):
        """memory (B, M, D) -> (tgt_in, logits or None), fresh tensors."""
        with self.model._ar_lock:
            self._reset(memory)
            first = 0
            if self.tgt_in.is_cuda and self.graph is None:
                self._capture()  # ran step 0
                first = 1
            run = self.step if self.graph is None else self.graph.replay
            for i in range(first, self.L):
                if i and bool(self.done):
                    break
                run()
            logits = None if self.logits is None else self.logits.clone()
            return self.tgt_in.clone(), logits


class PARSeq(TorchModel):
    #: stage label for utils.stagetrace accounting
    trace_stage = "rec"

    def __init__(self, cfg, device="cpu", dtype=None):
        super().__init__(cfg, device, dtype)
        self.max_label_length = cfg.max_label_length
        self.decode_ar = bool(cfg.decode_ar)
        self.refine_iters = int(cfg.refine_iters)
        self.num_tokens = cfg.num_tokens
        self.eos_id = 0
        self.bos_id = cfg.num_tokens - 2
        self.pad_id = cfg.num_tokens - 1
        self.img_size = tuple(cfg.data.img_size)
        self.dec_depth = cfg.decoder.depth
        D = cfg.decoder.embed_dim
        self.encoder = ViTEncoder(
            self.img_size, tuple(cfg.encoder.patch_size),
            cfg.encoder.embed_dim, cfg.encoder.depth, cfg.encoder.num_heads,
            cfg.encoder.mlp_ratio,
        )
        self.decoder = TwoStreamDecoder(
            D, cfg.decoder.num_heads, cfg.decoder.mlp_ratio, cfg.decoder.depth
        )
        self.head = nn.Linear(D, cfg.num_tokens - 2)
        self.text_embed = TokenEmbedding(cfg.num_tokens, D)
        # +1 for <eos>
        self.pos_queries = nn.Parameter(torch.zeros(1, cfg.max_label_length + 1, D))
        #: (batch size, memory length) -> _CachedARLoop (its buffers and its
        #: CUDA graph); a narrower canvas gives a shorter memory
        self._ar_loops = {}
        #: held by a decode on the loops' shared state, and while a loop is
        #: made (see _CachedARLoop)
        self._ar_lock = threading.Lock()
        self.int8_kv = _int8_kv_default(self.device)
        if self.int8_kv:
            _notice_int8_kv_default()
        self.finish_init()

    def init_extra(self, gen):
        trunc_normal_(self.encoder.pos_embed, 0.02, gen)
        trunc_normal_(self.pos_queries, 0.02, gen)

    # ------------------------------------------------------------ pieces

    def content_embeddings(self, tgt_in):
        """Content stream: [emb(BOS) | pos_q[i-1] + emb(tok_i)]."""
        L = tgt_in.shape[1]
        null_ctx = self.text_embed(tgt_in[:, :1])
        rest = self.pos_queries[:, :L - 1] + self.text_embed(tgt_in[:, 1:])
        return torch.cat([null_ctx, rest], dim=1)

    def content_row(self, tokens, j):
        """Content row j (>= 1) for tokens written at tgt_in[:, j]."""
        return self.pos_queries[:, j - 1:j] + self.text_embed(tokens[:, None])

    def position_queries(self, batch_size, num_steps):
        return self.pos_queries[:, :num_steps].expand(batch_size, -1, -1)

    def decode(self, tgt_query, content, memory, query_mask=None,
               content_mask=None, padding_mask=None):
        out = self.decoder(tgt_query, content, memory, query_mask,
                           content_mask, padding_mask)
        return self.head(out)

    # ----------------------------------------------------- decode program

    def _ar_cached(self, memory, B, L, causal):
        """Depth-1 AR loop with K/V caches -> tgt_in and (if no refine
        follows) the per-step logits, on the loop state kept for batch size
        ``B`` and this memory's length (see ``_CachedARLoop``)."""
        key = (B, memory.shape[1])
        with self._ar_lock:
            loop = self._ar_loops.get(key)
            if loop is None or loop.int8_kv != self.int8_kv:
                loop = self._ar_loops[key] = _CachedARLoop(self, B, L, causal,
                                                           self.int8_kv)
        return loop(memory)

    def _ar_uncached(self, memory, B, L, causal):
        """AR loop re-decoding the whole content stream (depth > 1)."""
        dev = memory.device
        tgt_in = torch.full((B, L), self.pad_id, dtype=torch.long, device=dev)
        tgt_in[:, 0] = self.bos_id
        carry = self.refine_iters == 0
        logits = torch.zeros(B, L, self.num_tokens - 2, device=dev) if carry else None
        pos_all = self.position_queries(B, L)
        for i in range(L):
            content = self.content_embeddings(tgt_in)
            p_i = self.decode(pos_all[:, i:i + 1], content, memory,
                              causal[i:i + 1]).float()
            if carry:
                logits[:, i:i + 1] = p_i
            if i + 1 >= L:
                break
            tgt_in[:, i + 1] = p_i[:, 0].argmax(-1)
            if bool((tgt_in == self.eos_id).any(-1).all()):
                break
        return tgt_in, logits

    @torch.no_grad()
    def forward_logits(self, images):
        """(B, H, W, 3) standardized float (or uint8, normalised on the
        device) -> final logits (B, L, num_tokens - 2) float32."""
        return self.logits_from_memory(self.encode(images))

    @torch.no_grad()
    def encode(self, images):
        """(B, H, W, 3) standardized float or uint8 -> encoder memory
        (B, M, D) in the compute dtype."""
        images = images.to(self.device)
        if images.dtype == torch.uint8:
            # device-side ToTensor + Normalize(0.5, 0.5)
            images = images.to(self.dtype) * (1.0 / 127.5) - 1.0
        return self.encoder(images.to(self.dtype))

    @torch.no_grad()
    def logits_from_memory(self, memory):
        """The decoder alone: encoder memory (B, M, D) -> final logits
        (B, L, num_tokens - 2) float32."""
        B = memory.shape[0]
        L = self.max_label_length + 1
        dev = memory.device
        # True = masked.  Causal: query i sees content <= i.
        causal = torch.triu(torch.ones(L, L, dtype=torch.bool, device=dev), 1)
        if self.decode_ar:
            ar = self._ar_cached if self.dec_depth == 1 else self._ar_uncached
            tgt_in_final, logits = ar(memory, B, L, causal)
        else:
            bos = torch.full((B, 1), self.bos_id, dtype=torch.long, device=dev)
            logits = self.decode(self.position_queries(B, L),
                                 self.content_embeddings(bos), memory).float()
        if self.refine_iters:
            # Cloze mask: query i may not see content i+1 (its own target).
            # The reference aliases the content mask to the same tensor, so
            # the cloze mask applies to BOTH streams during refinement.
            ones = torch.ones(L, L, dtype=torch.bool, device=dev)
            cloze = torch.triu(ones, 1) & ~torch.triu(ones, 2)
            bos = torch.full((B, 1), self.bos_id, dtype=torch.long, device=dev)
            for it in range(self.refine_iters):
                if it == 0 and self.decode_ar:
                    # [BOS | AR argmax ids]; tails past each row's first
                    # EOS hold PAD where the reference has argmax ids, but
                    # the padding mask below hides them
                    tgt_in = tgt_in_final
                else:
                    tgt_in = torch.cat([bos, logits[:, :-1].argmax(-1)], dim=1)
                padding_mask = (tgt_in == self.eos_id).int().cumsum(-1) > 0
                logits = self.decode(
                    self.position_queries(B, L), self.content_embeddings(tgt_in),
                    memory, cloze, cloze, padding_mask,
                ).float()
        return logits

    @torch.no_grad()
    def forward_probs(self, images):
        """(B, H, W, 3) -> full softmax distributions (B, L, num_tokens-2)."""
        return torch.softmax(self.forward_logits(images), dim=-1)

    @torch.no_grad()
    def forward_tokens_device(self, images):
        """Greedy reduction on the device: ids (B, L) int32 and their
        probabilities (B, L) float32, via logsumexp (no full softmax)."""
        logits = self.forward_logits(images)
        ids = logits.argmax(-1)
        lse = torch.logsumexp(logits, dim=-1)
        top = logits.gather(-1, ids[..., None])[..., 0]
        return ids.int(), torch.exp(top - lse)

    def forward_tokens(self, images: np.ndarray):
        """Host entry: (B, H, W, 3) ndarray -> (ids, probs) ndarrays."""
        with segment(self.trace_stage, "dispatch", nbytes=images.nbytes):
            ids, probs = self.forward_tokens_device(
                torch.from_numpy(np.ascontiguousarray(images))
            )
        with segment(self.trace_stage, "sync"):
            return ids.cpu().numpy(), probs.cpu().numpy()

    @torch.no_grad()
    def forward_tokens_from_page_device(self, page, mats, valid_wh, out_w=None):
        """Crop the lines out of the uint8 page on the device, normalise
        (x / 127.5 - 1) and decode -> ids (B, L) int32 and probs (B, L)
        float32 on the device.  ``page`` is a padded (H, W, 3) uint8 tensor
        on this model's device (ops.device_crop.DevicePage); ``mats``
        (B, 3, 3) canvas->page maps and ``valid_wh`` (B, 2) [new_w, new_h]
        come from ops.device_crop.line_homographies; every line crops
        through the projective gather.  ``out_w`` narrows the canvas (a
        width bucket): the crop of a line that fits is the left slice of
        its full-width crop, and the ViT takes the left columns of its
        position embedding."""
        from ..ops.device_crop import sample_lines

        out_hw = (self.img_size[0], int(out_w or self.img_size[1]))
        crops = sample_lines(
            page,
            torch.from_numpy(np.asarray(mats, np.float32)).to(page.device),
            torch.from_numpy(np.asarray(valid_wh, np.int32)).to(page.device),
            out_hw=out_hw,
        )
        return self.forward_tokens_device(crops * (1.0 / 127.5) - 1.0)

    def forward_tokens_from_page(self, page, mats, valid_wh, out_w=None):
        """Host entry of ``forward_tokens_from_page_device`` -> (ids, probs)
        ndarrays; only the maps go up and the greedy result comes back."""
        with segment(self.trace_stage, "dispatch"):
            ids, probs = self.forward_tokens_from_page_device(
                page, mats, valid_wh, out_w)
        with segment(self.trace_stage, "sync"):
            return ids.cpu().numpy(), probs.cpu().numpy()

    def audit_int8_kv(self, batch=None) -> bool:
        """One batch's greedy ids with the int8 memory-K/V cache against
        the full cache.  True when they agree (int8 stays on); on
        divergence (K projections whose outlier dimensions per-head
        quantization crushes) int8 is turned off for this model, with a
        warning, as the JAX package's audit does.  ``batch`` defaults to 4
        uniform random crops from seed 0."""
        if not self.int8_kv:
            return True
        if batch is None:
            h, w = self.img_size
            rng = np.random.default_rng(0)
            batch = rng.random((4, h, w, 3), np.float32) * 2.0 - 1.0
        ids8, _ = self.forward_tokens(batch)
        self.int8_kv = False
        ids32, _ = self.forward_tokens(batch)
        if np.array_equal(ids8, ids32):
            self.int8_kv = True
            return True
        logger.warning(
            "int8 memory-K/V greedy decode diverges from the full cache on "
            f"this checkpoint ({int((ids8 != ids32).sum())} token positions "
            "in the audit batch); falling back to the full-precision cache "
            "for this model; set YOMITOKU_TPU_INT8_KV=1 to force int8.")
        return False
