"""The fused page program (the port's counterpart of
yomitoku_tpu/ops/fused_page.py): the detector, the layout parser and its
top-k, the selection of the page's table detections, their crops from the
resident page and a region model on them (the table recognizer, or the
cell detector), all enqueued on the device with no readback between
them, and read back once as one packed uint8 wire:

    [det prob map u8 (1, oh, ow)] [layout (1, k, 6) f32]
    [region (K, q, 6) f32] [slot boxes (K, 4) f32] [slot valid (K,) f32]

The host learns which boxes are tables only from the layout's readback;
instead the program selects the top ``max_tables`` table-classified
layout detections above the layout threshold on the device, crops them
with the host's geometry (clip, truncate, clamp) and runs the region
model on the fixed batch of slots.  Tables the slots miss (more than
``max_tables``, or a box the host's filter kept that no slot holds) and
slots whose capped top-k saturated take the chunked region route
afterwards, loudly (``consume_region_slots``).  Padded slots crop the
1x1 corner and are dropped on the host by their validity.

The one deliberate difference from the JAX package's single jitted
program: the program is two legs, the detector on one of the owner's
two kept worker threads and layout -> slots -> region model on the
other.  Both legs only enqueue work on the device's current stream (no
readback, no host value of a device tensor); the caller joins them,
concatenates the wire and reads it back once.  Two legs keep the overlap
of the detector's and the layout's host dispatch, and kept threads keep
cuDNN's convolution plans, which PyTorch holds per thread (a model's
first call on a new thread plans every convolution again,
chip_smoke.py phase 9).  The same code runs on the CPU.

``FusedPageAnalysis.batch_call`` is the page axis (the JAX package's
``batch_call``, a vmap of its program): N same-shape padded pages stacked
on the device, the detector as one batch of N, the layout as one batch of
N, each page's slots cropped from its own page and the region model once
on the 4N slots, one wire for the chunk read back once.  Under a mesh each
of those batches splits over the models' replicas (``models/base.py``
``place_batch``).
"""

import os
from collections import defaultdict, deque

import numpy as np
import torch

from ..postprocessor.rtdetr_postprocessor import topk_packed
from ..utils.stagetrace import segment
from .device_crop import DevicePages, staged_page_mat, staged_wh


def _det_leg(det, page, page_hw, det_hw):
    """The detector's (1, oh, ow) uint8 map of the page, on the device."""
    return det.forward_from_page(page, tuple(page_hw), tuple(det_hw))


def _layout_topk(lay, page, page_hw, lay_hw, orig_wh, k):
    """The layout parser's (1, k, 6) packed top-k of the page, on the
    device."""
    lay_mat = staged_page_mat(tuple(page_hw), tuple(lay_hw), page.device)
    preds = lay.forward_from_page(page, lay_mat, tuple(lay_hw))
    return topk_packed(preds["pred_logits"], preds["pred_boxes"], orig_wh, k)


def select_slots(packed, orig_wh, table_label, lay_thresh, max_tables, region_hw):
    """The device's table slots, in the JAX program's order of operations
    (float32): the layout rows labelled ``table_label`` above
    ``lay_thresh``, their top ``max_tables`` by score, each box clipped at
    0, truncated and clamped to the page as the host's filter and
    preprocess do, degenerate or padded slots turned into the 1x1 corner.

    ``packed`` (1, k, 6), ``orig_wh`` (1, 2) [[w, h]] -> (sel (K, 4)
    x1 y1 x2 y2, valid (K,) bool, mats (K, 3, 3) canvas -> page maps of
    a resize to ``region_hw``, sizes (K, 2) as (w, h)), on the device;
    nothing is read back."""
    row = packed[0]
    W, H = orig_wh[0, 0], orig_wh[0, 1]
    zero = torch.zeros((), dtype=row.dtype, device=row.device)
    score = torch.where((row[:, 0] == table_label) & (row[:, 1] > lay_thresh),
                        row[:, 1], torch.full_like(row[:, 1], -1.0))
    top, idx = torch.topk(score, max_tables)
    valid = top > 0.0
    b = row.index_select(0, idx)[:, 2:6]

    def clip(x, lo, hi):
        return torch.minimum(torch.maximum(x, lo), hi)

    x1 = clip(torch.trunc(torch.maximum(b[:, 0], zero)), zero, W)
    y1 = clip(torch.trunc(torch.maximum(b[:, 1], zero)), zero, H)
    x2 = clip(torch.trunc(clip(b[:, 2], zero, W)), x1, W)
    y2 = clip(torch.trunc(clip(b[:, 3], zero, H)), y1, H)
    ok = valid & (x2 > x1) & (y2 > y1)
    one = torch.ones((), dtype=row.dtype, device=row.device)
    x1 = torch.where(ok, x1, zero)
    y1 = torch.where(ok, y1, zero)
    x2 = torch.where(ok, x2, one)
    y2 = torch.where(ok, y2, one)
    sel = torch.stack([x1, y1, x2, y2], dim=1)

    # the maps in float64, rounded to float32 once, as region_mats builds
    # them on the host for the unfused and the chunked routes: a table
    # gets the same crop on every route (the JAX program computes them in
    # float32, an ulp of the page coordinate apart)
    oh, ow = region_hw
    x1d, y1d = x1.double(), y1.double()
    sx = (x2.double() - x1d) / ow
    sy = (y2.double() - y1d) / oh
    zeros, ones = torch.zeros_like(sx), torch.ones_like(sx)
    mats = torch.stack([
        torch.stack([sx, zeros, x1d + 0.5 * sx - 0.5], 1),
        torch.stack([zeros, sy, y1d + 0.5 * sy - 0.5], 1),
        torch.stack([zeros, zeros, ones], 1),
    ], dim=1).float()
    sizes = torch.stack([x2 - x1, y2 - y1], dim=1)
    return sel, valid, mats, sizes


def _u8(t):
    """A device tensor's float32 bytes, flat."""
    return t.to(torch.float32).contiguous().view(torch.uint8).reshape(-1)


def _u8_rows(t, rows):
    """A device tensor's float32 bytes as ``rows`` rows (one per page)."""
    return _u8(t).reshape(rows, -1)


def _legs(executor, *legs):
    """Run each leg on ``executor`` (inline without one) and join them."""
    if executor is None:
        return [leg() for leg in legs]
    futures = [executor.submit(leg) for leg in legs]
    return [f.result() for f in futures]


def _unpack_prob(flat_u8, det_out_hw):
    """The wire's prob section -> the (1, oh, ow) uint8 map (prob * 255):
    the port's DBNet ships the plain map (the JAX package's packed head is
    a TPU layout)."""
    oh, ow = det_out_hw
    return flat_u8.reshape(1, oh, ow)


class FusedDetLayout:
    """The program's first two legs alone: (DevicePage, page_hw,
    det_out_hw, lay_out_hw) -> (det prob map (1, oh, ow) uint8, layout
    packed (1, k, 6) float32), one readback."""

    def __init__(self, det_model, lay_model, num_top_queries):
        self.det = det_model
        self.lay = lay_model
        self.k = int(num_top_queries)

    @torch.no_grad()
    def __call__(self, page, page_hw, det_out_hw, lay_out_hw, executor=None):
        h, w = page_hw
        orig_wh = staged_wh(w, h, page.dev.device)
        with segment("det+layout", "dispatch"):
            prob, packed = _legs(
                executor,
                lambda: _det_leg(self.det, page.dev, page_hw, det_out_hw),
                lambda: _layout_topk(self.lay, page.dev, page_hw, lay_out_hw, orig_wh,
                                     self.k),
            )
            wire = torch.cat([prob.reshape(-1), _u8(packed)])
        with segment("det+layout", "sync", nbytes=wire.numel()):
            arr = wire.cpu().numpy()
        n_prob = det_out_hw[0] * det_out_hw[1]
        packed = np.ascontiguousarray(arr[n_prob:]).view(np.float32).reshape(1, self.k, 6)
        return _unpack_prob(arr[:n_prob], det_out_hw), packed


class FusedPageAnalysis:
    """The detector, the layout parser and a per-table region model (the
    table recognizer for DocumentAnalyzer, the cell detector for
    TableSemanticParser) over one page, one readback (see the module
    docstring).  ``YOMITOKU_TPU_FUSED_REGION_TOPK`` (default 640, 0 for
    none) caps the region rows the wire ships per slot."""

    def __init__(self, det_model, lay_model, tsr_model, lay_top_k, tsr_top_k,
                 table_label, lay_thresh, max_tables=4, trace_label="det+layout+tsr"):
        self.det = det_model
        self.lay = lay_model
        self.tsr = tsr_model
        self.trace_label = trace_label
        self.lay_k = int(lay_top_k)
        # the CellDetector's 2,500-query top-k would ship 240 KB a page
        # where tables keep far fewer cells above threshold: cap the wire,
        # and consume_region_slots re-dispatches, loudly, any slot whose
        # capped list may have cut rows above the threshold
        cap = int(os.environ.get("YOMITOKU_TPU_FUSED_REGION_TOPK", "640"))
        self.tsr_full_k = int(tsr_top_k)
        self.tsr_k = min(self.tsr_full_k, cap) if cap > 0 else self.tsr_full_k
        self.table_label = int(table_label)
        self.lay_thresh = float(lay_thresh)
        self.max_tables = int(max_tables)

    def _region_leg(self, page, page_hw, lay_hw, region_hw, orig_wh):
        """Layout -> table slots -> region model, enqueued on the device
        -> (packed, packed_t, sel, valid) device tensors."""
        packed = _layout_topk(self.lay, page, page_hw, lay_hw, orig_wh, self.lay_k)
        sel, valid, mats, sizes = select_slots(
            packed, orig_wh, self.table_label, self.lay_thresh, self.max_tables,
            tuple(region_hw))
        preds = self.tsr.forward_from_page(page, mats, tuple(region_hw))
        packed_t = topk_packed(preds["pred_logits"], preds["pred_boxes"], sizes,
                               self.tsr_k)
        return packed, packed_t, sel, valid

    @torch.no_grad()
    def enqueue(self, page, page_hw, det_out_hw, lay_out_hw, tsr_out_hw,
                executor=None):
        """Both legs enqueued (on ``executor``'s threads where given) and
        joined -> the wire, a uint8 tensor on the page's device that
        nothing has read back yet."""
        h, w = page_hw
        orig_wh = staged_wh(w, h, page.dev.device)
        prob, (packed, packed_t, sel, valid) = _legs(
            executor,
            lambda: _det_leg(self.det, page.dev, page_hw, det_out_hw),
            lambda: self._region_leg(page.dev, page_hw, lay_out_hw, tsr_out_hw,
                                     orig_wh),
        )
        return torch.cat([prob.reshape(-1), _u8(packed), _u8(packed_t), _u8(sel),
                          _u8(valid)])

    def __call__(self, page, page_hw, det_out_hw, lay_out_hw, tsr_out_hw,
                 executor=None):
        """One page (a DevicePage) -> (prob, packed, packed_t, sel, valid)
        host arrays: the detector's (1, oh, ow) uint8 map, the layout's
        (1, k, 6) rows, the slots' (K, 1, q, 6) region rows, their (K, 4)
        int64 boxes and (K,) validity."""
        with segment(self.trace_label, "dispatch"):
            wire = self.enqueue(page, page_hw, det_out_hw, lay_out_hw, tsr_out_hw,
                                executor)
        with segment(self.trace_label, "sync", nbytes=wire.numel()):
            arr = wire.cpu().numpy()
        return self._split_wire(arr, det_out_hw)

    def _region_leg_batch(self, pages, page_hws, lay_hw, region_hw, orig_wh):
        """``_region_leg`` over a stack of N pages: the layout on the N
        resized pages as one batch, each page's slots selected from its
        own rows and cropped from its own page, the region model once on
        the N * max_tables slots -> (packed (N, k, 6), packed_t (N * K, q,
        6), sel (N, K, 4), valid (N, K)) device tensors."""
        dev = pages.device
        lay_mats = torch.stack([staged_page_mat(tuple(hw), tuple(lay_hw), dev)
                                for hw in page_hws])
        preds = self.lay.forward_from_pages(pages, lay_mats, tuple(lay_hw))
        packed = topk_packed(preds["pred_logits"], preds["pred_boxes"], orig_wh, self.lay_k)
        slots = [select_slots(packed[i:i + 1], orig_wh[i:i + 1], self.table_label,
                              self.lay_thresh, self.max_tables, tuple(region_hw))
                 for i in range(len(page_hws))]
        sel, valid, mats, sizes = (torch.stack(t) for t in zip(*slots))
        preds = self.tsr.forward_from_pages(pages, mats, tuple(region_hw))
        packed_t = topk_packed(preds["pred_logits"], preds["pred_boxes"],
                               sizes.reshape(-1, 2), self.tsr_k)
        return packed, packed_t, sel, valid

    @torch.no_grad()
    def enqueue_batch(self, pages_dev, page_hws, det_out_hw, lay_out_hw, tsr_out_hw,
                      executor=None):
        """``enqueue`` over a stack of pages: both legs on ``executor``'s
        threads -> the chunk's wire, (N, bytes) uint8 on the pages' device,
        one row per page laid out as ``enqueue``'s."""
        n = len(page_hws)
        orig_wh = torch.cat([staged_wh(w, h, pages_dev.device) for h, w in page_hws])
        prob, (packed, packed_t, sel, valid) = _legs(
            executor,
            lambda: self.det.forward_from_pages(pages_dev, page_hws, tuple(det_out_hw)),
            lambda: self._region_leg_batch(pages_dev, page_hws, lay_out_hw, tsr_out_hw,
                                           orig_wh),
        )
        return torch.cat([prob.reshape(n, -1), _u8_rows(packed, n), _u8_rows(packed_t, n),
                          _u8_rows(sel, n), _u8_rows(valid, n)], dim=1)

    def batch_call(self, pages_dev, page_hws, det_out_hw, lay_out_hw, tsr_out_hw,
                   executor=None):
        """(N, PH, PW, 3) uint8 stacked pages on the device, whose true (h,
        w) ``page_hws`` may differ, sharing the padded shape and the
        detector's, layout's and region's output sizes -> a list of N
        per-page (prob, packed, packed_t, sel, valid), as ``__call__``
        returns for one page: one enqueue, one readback for the chunk."""
        with segment(self.trace_label, "dispatch"):
            wire = self.enqueue_batch(pages_dev, page_hws, det_out_hw, lay_out_hw,
                                      tsr_out_hw, executor)
        with segment(self.trace_label, "sync", nbytes=wire.numel()):
            arr = wire.cpu().numpy()
        return [self._split_wire(row, det_out_hw) for row in arr]

    def _split_wire(self, arr, det_out_hw):
        """One page's wire bytes -> (prob, packed, packed_t, sel, valid)."""
        oh, ow = det_out_hw
        K, k, q = self.max_tables, self.lay_k, self.tsr_k
        cuts = np.cumsum([oh * ow, k * 24, K * q * 24, K * 16, K * 4])
        with segment("det", "unpack"):
            prob = _unpack_prob(arr[: cuts[0]], det_out_hw)

        def f32(a):
            return np.ascontiguousarray(a).view(np.float32)

        packed = f32(arr[cuts[0]:cuts[1]]).reshape(1, k, 6)
        packed_t = f32(arr[cuts[1]:cuts[2]]).reshape(K, 1, q, 6)
        sel = f32(arr[cuts[2]:cuts[3]]).reshape(K, 4).astype(np.int64)
        valid = f32(arr[cuts[3]:cuts[4]]) > 0.0
        return prob, packed, packed_t, sel, valid

    def consume_region_slots(self, region_data, packed_t, sel, sel_valid,
                             postprocessor, threshold):
        """Match each host-kept region (``region_data`` from
        ``_preprocess_meta``: dicts with "offset" (x, y) and "size" (h, w))
        to its slot by the same truncated and clamped box, and filter that
        slot's rows at ``threshold``.

        -> (filtered, missing_idx, missing_data): ``filtered[i]`` is region
        i's {labels, boxes, scores}, or None where it must take the chunked
        region route: no slot holds its box (more than max_tables, or the
        host's filter kept a box the slots do not hold), or the capped
        top-k saturated above the threshold (every shipped row passed, so
        rows beyond the cap could have too; logged as a warning)."""
        slot_of = {tuple(sel[j]): j for j in range(len(sel_valid)) if sel_valid[j]}
        filtered = [None] * len(region_data)
        missing_idx, missing_data = [], []
        for i, d in enumerate(region_data):
            x1, y1 = d["offset"]
            hh, ww = d["size"]
            j = slot_of.pop((x1, y1, x1 + ww, y1 + hh), None)
            one = None
            if j is not None:
                one = postprocessor.filter_packed(packed_t[j], [[ww, hh]], threshold)[0]
                if self.tsr_k < self.tsr_full_k and len(one["scores"]) >= self.tsr_k:
                    from ..utils.logger import set_logger

                    set_logger(__name__, "WARNING").warning(
                        "fused region wire top-%d saturated above threshold for "
                        "region %s; re-dispatching it at full top-%d (raise "
                        "YOMITOKU_TPU_FUSED_REGION_TOPK to avoid the extra round "
                        "trip)", self.tsr_k, d["offset"], self.tsr_full_k)
                    one = None
            if one is None:
                missing_idx.append(i)
                missing_data.append(d)
            filtered[i] = one
        return filtered, missing_idx, missing_data


def dp_chunk_pages(mesh, n_pages):
    """Pages per ``batch_call``: the mesh's dp size, else (one device)
    YOMITOKU_TPU_DP_CHUNK (default 1), at most the pages there are."""
    if mesh is not None:
        return mesh.shape["dp"]
    return max(1, min(n_pages, int(os.environ.get("YOMITOKU_TPU_DP_CHUNK", "1"))))


def run_page_chunks(prog, imgs, det_hws, lay_hw, region_hw, device, chunk_pages,
                    post_one, pools, executor):
    """The page-axis schedule of both analyzers' ``_batch_dp_fused`` (the
    JAX package's): pages grouped by (padded shape, detector size), cut
    into chunks of ``chunk_pages`` (a short chunk padded by repeating its
    first page, whose lanes are dropped), each chunk's device leg (one
    ``DevicePages`` upload and one ``batch_call``, its two legs on
    ``executor``) on a pool YOMITOKU_TPU_DP_DEVICE_DEPTH deep (default 4),
    and each page's host tail ``post_one(i, page, wire)`` on a pool of
    YOMITOKU_TPU_DP_TAIL_WORKERS threads (default max(4, chunk_pages))
    behind them, at most 2 x chunk_pages tails open.  The pools are
    ``pools``'s, kept.  -> the tails' results in input order."""
    groups = defaultdict(list)
    for i, img in enumerate(imgs):
        h, w = img.shape[:2]
        groups[(-(-h // 512), -(-w // 512), tuple(det_hws[i]))].append(i)
    chunks = [(members[s:s + chunk_pages], key[2])
              for key, members in groups.items()
              for s in range(0, len(members), chunk_pages)]

    def device_leg(ids, det_hw):
        pad_ids = ids + [ids[0]] * (chunk_pages - len(ids))
        pages = DevicePages([imgs[i] for i in pad_ids], device)
        return pages, prog.batch_call(pages.dev, pages.hws, det_hw, lay_hw, region_hw,
                                      executor=executor)

    dev_depth = max(1, int(os.environ.get("YOMITOKU_TPU_DP_DEVICE_DEPTH", "4")))
    tail_workers = (int(os.environ.get("YOMITOKU_TPU_DP_TAIL_WORKERS", "0"))
                    or max(4, chunk_pages))
    leg_pool = pools.get("leg", dev_depth)
    tail_pool = pools.get("tail", tail_workers)
    legs = deque((ids, leg_pool.submit(device_leg, ids, hw)) for ids, hw in chunks[:dev_depth])
    next_chunk = dev_depth
    results = [None] * len(imgs)
    tails = deque()
    while legs:
        ids, fut = legs.popleft()
        pages, per_page = fut.result()
        if next_chunk < len(chunks):
            c_ids, c_hw = chunks[next_chunk]
            legs.append((c_ids, leg_pool.submit(device_leg, c_ids, c_hw)))
            next_chunk += 1
        for j, i in enumerate(ids):
            tails.append((i, tail_pool.submit(post_one, i, pages.page(j), per_page[j])))
        while len(tails) > 2 * chunk_pages:
            i, tail = tails.popleft()
            results[i] = tail.result()
    while tails:
        i, tail = tails.popleft()
        results[i] = tail.result()
    return results
