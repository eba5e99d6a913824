"""Whether what the timed path produced is correct: each number compared
with the plain reference (``portbench/reference``) beside its limit.

Every page completed in the window:
  * ``lines_off``: planned lines without a word whose quad is exactly the
    reference postprocessor's quad for that line's painted core (limit 0);
  * ``text_off``: words whose text is not the NFKC of the charset decode
    of the recognizer's final ids up to the first EOS, whose direction is
    not horizontal, or whose detection score is not the painted value
    (limit 0).
A sample of those pages, drawn from the seed before the window (every
line of each):
  * ``unsampled``: sampled pages that did not complete in the window, or
    whose results the run did not keep (limit 0);
  * ``det_map_q``: the detector's own map (before the painted one took its
    place) against the reference DBNet on the reference's resize of the
    page, the largest difference in map quanta (1/255);
  * ``ar_gap``: the reference recognizer on the reference's crops, fed
    the program's AR ids teacher-forced: the widest gap by which the id
    the program wrote at a step lies below the reference's best logit;
  * ``refine_gap``: the same for the refine over the program's AR ids and
    the program's final ids.
The reference follows the program's AR ids (its own state) into the
refine; the AR ids themselves are checked step by step by ``ar_gap``.
With ``control`` the same numbers are read for the reference in float8
put in the program's place (at each position, the id the control puts
first)."""

import unicodedata
from pathlib import Path

import numpy as np
import torch

from portbench.reference import dbnet as ref_dbnet
from portbench.reference import pages as ref_pages
from portbench.reference import parseq as ref_parseq
from portbench.reference import quads as ref_quads
from portbench.reference.precision import Precision, no_tf32

ROOT = Path(__file__).resolve().parents[2]
#: lines the reference encoder takes at a time
BLOCK = 64
#: pages of the window the recognizer and detector checks sample
SAMPLE = 2


def expected_quads(config, page):
    det = config["text_detector"]
    return ref_quads.expected_quads(page.cores, page.map.shape[1:], page.image.shape[:2],
                                    det["unclip_ratio"])


def charset(config):
    """The recognizer's charset: the data file the configuration names."""
    return (ROOT / config["charset"]).read_text(encoding="utf-8")


def decode(ids, chars):
    """Greedy ids -> text: up to the first EOS (0), charset ids shifted by
    one, BOS and PAD by their names, NFKC."""
    table = ("[E]",) + tuple(chars) + ("[B]", "[P]")
    out = []
    for i in ids:
        if i == 0:
            break
        out.append(table[i])
    return unicodedata.normalize("NFKC", "".join(out))


def page_checks(config, traffic, page, record, chars):
    """(lines_off, text_off, matched) of one page: ``matched`` the index of
    each word's planned line (or -1)."""
    want = {tuple(map(tuple, q)): i for i, q in enumerate(expected_quads(config, page).tolist())}
    score = traffic["paint_value"] / 255.0
    words = record.words or []
    bs = config["text_recognizer"]["batch_size"]
    matched, text_off = [], 0
    for j, w in enumerate(words):
        matched.append(want.get(tuple(map(tuple, w.points)), -1))
        k, r = divmod(j, bs)
        if k >= len(record.final) or r >= len(record.final[k]):
            text_off += 1
            continue
        if (w.content != decode(record.final[k][r], chars) or w.direction != "horizontal"
                or abs(w.det_score - score) > 1e-6):
            text_off += 1
    lines_off = len(page.lines) - len({m for m in matched if m >= 0})
    return lines_off, text_off, matched


def _widest_gap(ref_logits, ids):
    """max over positions of (reference best logit - reference logit of
    ``ids``); an id no class of the head has reads infinite."""
    ids = ids.long()
    outside = (ids < 0) | (ids >= ref_logits.shape[-1])
    if bool(outside.any()):
        return float("inf")
    best = ref_logits.max(-1).values
    got = ref_logits.gather(-1, ids[..., None])[..., 0]
    return float((best - got).max())


def deep_checks(config, page, record, matched, det_w, rec_w, device, control=False):
    """{name: reading} of the sampled numbers on one page; with
    ``control``, {name: (program reading, control reading)}."""
    no_tf32()
    f32, f8 = Precision(), Precision(fp8=True)
    det_cfg, rec_cfg = config["text_detector"], config["text_recognizer"]
    pd = {k: v.float() for k, v in det_w.items()}
    pr = {k: v.float() for k, v in rec_w.items()}
    image = torch.from_numpy(page.image).to(device)
    out = {}
    with torch.no_grad():
        x = ref_pages.detector_input(image, page.map.shape[1:])
        ref_map = _wire(ref_dbnet.forward(pd, x, f32))
        got = record.real_map.to(device).reshape(ref_map.shape).float()
        out["det_map_q"] = [float((got - ref_map).abs().max())]
        if control:
            out["det_map_q"].append(float((_wire(ref_dbnet.forward(pd, x, f8)) - ref_map)
                                          .abs().max()))
        del x
        quads = expected_quads(config, page)
        bs = rec_cfg["batch_size"]
        rows = [(j, m) for j, m in enumerate(matched) if m >= 0]
        ar_gap, refine_gap = [0.0, 0.0], [0.0, 0.0]
        for s in range(0, len(rows), BLOCK):
            block = rows[s:s + BLOCK]
            crops = ref_pages.line_crops(image, quads[[m for _, m in block]],
                                         tuple(rec_cfg["img_size"]))
            tgt = torch.stack([record.ar[j // bs][j % bs] for j, _ in block]).to(device).long()
            final = torch.from_numpy(np.stack([record.final[j // bs][j % bs]
                                               for j, _ in block])).to(device)
            memory = ref_parseq.encode(pr, rec_cfg, crops, f32)
            steps = _steps(tgt)
            ar = ref_parseq.ar_logits(pr, rec_cfg, memory, tgt, f32)[:, :steps]
            ar_gap[0] = max(ar_gap[0], _widest_gap(ar, tgt[:, 1:steps + 1]))
            ref = ref_parseq.refine_logits(pr, rec_cfg, memory, tgt, f32)
            refine_gap[0] = max(refine_gap[0], _widest_gap(ref, final))
            if control:
                mem8 = ref_parseq.encode(pr, rec_cfg, crops, f8)
                ar8 = ref_parseq.ar_logits(pr, rec_cfg, mem8, tgt, f8)[:, :steps]
                ar_gap[1] = max(ar_gap[1], _widest_gap(ar, ar8.argmax(-1)))
                ref8 = ref_parseq.refine_logits(pr, rec_cfg, mem8, tgt, f8)
                refine_gap[1] = max(refine_gap[1], _widest_gap(ref, ref8.argmax(-1)))
        out["ar_gap"], out["refine_gap"] = ar_gap[:1 + control], refine_gap[:1 + control]
    return {k: (tuple(v) if control else v[0]) for k, v in out.items()}


def _wire(prob):
    """A probability map as the program's uint8 wire: round(p * 255)."""
    return torch.clamp(torch.round(prob * 255.0), 0, 255)


def _steps(tgt):
    """AR steps whose ids the loop wrote: L - 1, or fewer where every row
    held an EOS early (later positions keep their PAD)."""
    hit = tgt[:, 1:] == 0
    if bool(hit.any(1).all()):
        return int(hit.int().argmax(1).max()) + 1
    return tgt.shape[1] - 1


def sample_numbers(seed, pages):
    """The numbers of the window's pages the deep checks read: SAMPLE of
    the first ``pages`` (at least one), drawn from the seed."""
    pages = max(1, pages)
    rng = np.random.default_rng([int(seed) & (2**63 - 1), 7])
    return frozenset(int(i) for i in rng.choice(pages, size=min(SAMPLE, pages), replace=False))


def judge(config, traffic, pool, inside, keep, det_w, rec_w, device, control=False):
    """[(name, reading, limit)] of the run (module docstring): ``inside``
    the pages completed in the window, ``keep`` the sampled page numbers;
    with ``control`` each deep reading is (program, control)."""
    chars = charset(config)
    limits = config["limits"]
    lines_off = text_off = 0
    matched = {}
    for r in inside:
        lo, to, m = page_checks(config, traffic, pool[r.pool], r, chars)
        lines_off, text_off = lines_off + lo, text_off + to
        matched[r.number] = m
    zero = (0.0, 0.0) if control else 0.0
    deep = {"det_map_q": zero, "ar_gap": zero, "refine_gap": zero}
    picked = [r for r in inside if r.number in keep and r.real_map is not None]
    for r in picked:
        got = deep_checks(config, pool[r.pool], r, matched[r.number], det_w, rec_w, device,
                          control)
        deep = {k: (tuple(map(max, deep[k], got[k])) if control else max(deep[k], got[k]))
                for k in deep}
    checks = [("lines_off", lines_off, 0), ("text_off", text_off, 0),
              ("unsampled", len(keep) - len(picked), 0)]
    checks += [(k, v, limits.get(k, -1.0)) for k, v in deep.items()]
    return checks
