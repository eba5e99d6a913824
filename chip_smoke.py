#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``yomitoku_tpu_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --fused-kernels [ROOT]
    python3 chip_smoke.py --deform-kernels [ROOT]
    python3 chip_smoke.py --attention-kernels [ROOT]
    python3 chip_smoke.py --page
    python3 chip_smoke.py --document
    python3 chip_smoke.py --cli
    python3 chip_smoke.py --semantic
    python3 chip_smoke.py --dp
    python3 chip_smoke.py --tp
    python3 chip_smoke.py --lite

With no arguments it runs the phases below, each printed as it runs; any
failure exits non-zero.  ``--page`` runs phase 8 alone, ``--document``
phase 9, ``--cli`` phase 9's analyzer setup and then phase 10,
``--semantic`` phase 9's analyzer setup and then phase 11, ``--dp``
phase 9's analyzer setup and then phase 12, ``--tp`` phase 13, ``--lite``
phase 14 (with phase 9's analyzer setup).  ``--fused-kernels [ROOT]`` runs only phase 7's
bottleneck kernels at their eleven shapes and the fused DBNet forward's
device busy, ``--deform-kernels [ROOT]`` only phase 2's
ms_deformable_attention lines at its four shapes, and ``--attention-kernels
[ROOT]`` only the attention kernel's main-path rows (kernels 1 and 3 at the
recognizer's shapes, 3 at RT-DETR's, 6 and 7 as phase 7 runs them), on the
package of this checkout or of another commit unpacked at ROOT (git
archive), to compare two trees on one card; each ends with a JSON line of
its times.


1. Card: name and power limit (nvidia-smi), and the kernel build time
   (the CUDA sources under yomitoku_tpu_torch/csrc compile here), with
   the registers and spills of every attention kernel instantiation
   (ptxas; a spill fails the run), of every GEMM kernel (the two
   wgmma schedules in both weight layouts, the f32 and LayerNorm kernels)
   and of every int8 GEMM kernel (the two int8 routes for f32 and bf16
   output, with and without GELU) and the row-quantize kernel, and of the
   convolution kernels of csrc/bottleneck.cu (the four TMA + wgmma unit
   shapes, the split route's combine pass, the f32 kernel), and of the 13
   deformable gather kernels (``deform_gather_kernel<T, G, V, E>``: G lanes
   per tap row, V elements per load, E loads per lane and tap); a spill
   fails the run.
2. Kernels: each of the four OCR kernels at the recognizer's shapes
   against its plain PyTorch version on the same CUDA inputs (f32 kernel
   vs f32 reference at max|d| <= 1e-4 max|ref| + 1e-5 with TF32 off; bf16
   kernel vs f32 reference at max|d| <= 2e-2 max|ref|; for the two
   residual sublayers also against the scale of their own delta ref - x),
   with the weights as the models pass them (torch Linear weights ``.t()``)
   and as row-major (in, out) tensors, then the median time of the kernel,
   of the plain version and of the stock bf16 torch op over 10 runs after
   warm-up.  The same for the layout kernels at RT-DETR's shapes:
   ``ms_deformable_attention`` at the layout decoder's (B=1, Lq=300), the
   table recognizer's (B=4, Lq=300) and the cell detector's Lq=2500 (stock:
   ``F.grid_sample`` per level; also the cell detector's four tables at
   Lq=2500; a line each with the route of the bf16 and
   f32 calls, bf16 and f32 device and per-call times, the tap bytes B Lq
   nh P 4 c itemsize and the achieved tap GB/s beside the bound (the value
   rows the in-map taps need, counted on these inputs, beside the bound
   with all of value read), the host time per call with the level plan
   cached and built per call, and the scalar route on value passed one
   element off 16-byte alignment, held to the plain version and timed),
   and ``fused_attention_heads`` at the AIFI
   (L=400) and decoder (L=300) self-attention, 8 heads of 32, at B=1 and
   B=4, and at the cell detector's decoder self-attention over 2,500
   queries at B=1 and B=4, which must take route "wgmma" (stock: SDPA).  At each attention shape (the refine, AIFI and
   decoder at B=1 and 4, and the ViT's in phase 7) a line ``attention
   ...`` gives the attention kernel's route, its device time against one
   SDPA call's (profiler), its bound and TFLOP/s; at the refine's and the
   ViT's a line ``attention consumer warpgroups ...`` gives the device time
   of the kernel with two consumer warpgroups per block (route "wgmma")
   and with one ("wgmma_small" unsplit) on the same inputs.  The four OCR
   kernels are timed per call and on the device (profiler), beside the
   stock composition's device time.  Then the GEMM kernel alone: a line
   ``gemm [label] ...`` at every bf16 GEMM shape of the main paths (the
   ViT's QKV, out-projection, fc1 and fc2 at M = 51,200, its QKV and
   out-projection at batch 1, M = 400, the refine MLP's fc1 and fc2 at
   M = 12,928, fused_attention_block's two at M = 400), with the epilogue
   the path runs, in both weight layouts: its route, max|d| against the
   f32 product of the same bf16 values (2e-2 of the largest value), device
   ms and TFLOP/s, one torch.matmul at the same (M, K, N) on the device as
   cuBLAS's yardstick, and the bound; and a line ``gemm schedules [label]
   ...`` with the device time of both bf16 schedules on the same inputs
   (two consumer warpgroups taking 128 x 128 units in turns, "wgmma"; one
   warpgroup on 64 x 128 units, "wgmma_small"), the two sides of the
   route's choice.
3. The OCR path: ``OCR(device="cuda")`` (DBNet dbnetv2_1 + PARSeq
   parseq-large-v4_1, seed-0 random weights) on demo/sample_text.png, its
   recognizer on a synthetic page of 128+ lines (a full batch of 128), the
   four launch counters of that run and the attention kernel's launches
   by route (every bf16 path's attention on a wgmma route, none on the FMA
   kernel, in phases 3, 4, 6 and 7) and the GEMM kernel's (none on "fma"
   in phases 3, 4, 6 and 7), the bf16 decode in ms per batch, its device
   busy time and the attention and GEMM kernels' shares of it, and two
   16-line f32 recognizer runs
   on the card (the first captures the AR step's CUDA graph, the second
   replays it) against the same weights on the CPU (plain path).
4. The layout path: ``LayoutAnalyzer(device="cuda")`` (RT-DETRv2
   rtdetrv2v2 layout parser + rtdetrv2 table structure recognizer, 640x640,
   300 queries, seed-0 random weights) on demo/sample_table.png, then its
   recognizer batched over 4 fixed table boxes of that page, the launch
   counters of that run, the deformable kernel's launches by route (a
   bf16 launch on the scalar route fails the run), ms/page, a
   torch.profiler window over the layout
   parser and the recognizer (device busy time, idle share, device
   operations per call), and an f32 RT-DETRv2 on the card against the
   same weights on the CPU (selected-query sets, logits and boxes).
5. The int8 kernels: ``fused_attention_block_ln_int8`` and
   ``fused_mlp_ln_int8`` at the recognizer's shapes (x (128, 400, 768),
   hidden 3072 in chunks of 1024, 8 heads) against their plain versions
   (bf16 within 2e-2 of the largest value; f32 within 1e-4 of it plus 1e-5
   on all rows but those where a code moved by one step at a rounding tie,
   at most 1%, which stay within 2e-2), then the times of the kernel, the
   plain version and the stock composition (LayerNorm, row quantize,
   ``torch._int_mm``, dequantize), per call and on the device (profiler).
   Then the int8 GEMM kernel alone: a line ``gemm_int8 [label] ...`` at
   each int8 GEMM of the two sublayers (QKV, out-projection, fc1 with its
   f32 GELU output, fc2 with K in three chunks, all at M = 51,200, and the
   QKV and out-projection at batch 1, M = 400), with the sublayer's
   epilogue: its route, max|d| against the plain version on the same codes
   and scales (f32 within 1e-5 of the largest value, bf16 within 2^-8),
   device ms and TOP/s, one ``torch._int_mm`` at the same (M, K, N) on the
   device as cuBLASLt's yardstick (int32 out, no epilogue), and the bound;
   a line ``gemm_int8 routes [label]`` with the device time of each int8
   route that takes the shape, on the same inputs; and a line
   ``quantize_rows [label]`` at the row-quantize kernel's three shapes
   (the LayerNorm of the bf16 input, the f32 attention output, the f32
   GELU output in three chunks): codes against the plain version's, device
   ms and bound.
6. The int8 recognizer path: ``TextRecognizer(device="cuda")`` with
   YOMITOKU_TPU_INT8_ENCODER=1 and the int8 memory-K/V cache at its CUDA
   default, on the synthetic page: the launch counters of that run (and of
   one batch of 128), the int8 GEMM's launches by route (two per int8
   sublayer launch), lines/s end to end and device decode, the device busy
   time of the decode and the int8 GEMM's share of it, the share of
   greedy ids equal to the bf16 path's (phase 3, full K/V cache), the
   int8-K/V audit's result, and the f32 int8 recognizer on the card against
   the same weights on the CPU (plain int8 path) on 8 lines, in two hops:
   the encoder's memory, then the decoder with the int8 K/V cache on the
   CPU's memory (greedy ids equal; a line may part at a near-tie).
7. The fused backbone (YOMITOKU_TPU_FUSED_BOTTLENECK=1,
   YOMITOKU_TPU_FUSED_STAGE=1): ``fused_bottleneck`` at each distinct
   stride-1 block shape of DBNet at 1600x1184 and PResNet-50-d at 640x640,
   ``fused_identity_stage`` at each DBNet stage tail, ``fused_attention``
   at the ViT's (128, 8, 400, 96) and ``fused_attention_block`` at the
   AIFI's (1, 400, 256) with 8 heads, against their plain versions (f32
   within 1e-4 of the largest value plus 1e-5 with TF32 off; bf16 within
   2e-2 of it, the bottleneck kernels against the plain version on the
   same bf16 values, which rounds h1 and h2 where they do), the unfused
   cuDNN blocks in f32 against the same plain version, then the times of
   the kernel, the plain version and the stock op (the unfused modules in
   channels_last bf16; SDPA; torch ops), per call and on the device.  At
   each bottleneck shape, a line ``conv [<shape>/<conv>] ...`` for each of
   its three convolutions (reduce, conv3x3, expand), launched alone on the
   route its plan picks: the route, the unit's patch and its padding share,
   max|d| against the plain version on the same bf16 values (2e-2 of the
   largest value), device ms, TFLOP/s, the bound, and one F.conv2d call
   with the folded weight and bias (bf16, channels_last) as cuDNN's
   yardstick; and a line ``conv routes [<shape>/<conv>] ...`` with the
   device time of every route that takes it on the same inputs.  Then
   the path: ``OCR(device="cuda")`` on demo/sample_text.png and
   ``LayoutAnalyzer(device="cuda")`` on demo/sample_table.png with its
   recognizer on the 4 fixed boxes, with both switches on: launch counts,
   the convolution kernel's launches by route (a bf16 convolution on the
   f32 "fma" kernel fails the run), ms/page and device time of the
   detector and layout models against the default backbone in the same
   run, csrc/bottleneck.cu's share of the fused DBNet forward's device
   busy time, DBNet's bf16 map fused against
   unfused (max|d| <= 3e-2, mean <= 2e-3: the JAX package's in-model
   bound), and DBNet (at 1600x1184) and RT-DETRv2 in f32 on the card
   against the same weights on the CPU with the gates forced open there.
8. The device-page route, the CUDA default (phases 3-7 pin the host-crop
   route, YOMITOKU_TPU_HOST_CROPS=1, so their numbers stay comparable):
   ``sample_lines`` and ``sample_regions_separable`` on the card against
   the CPU (the synthetic page's lines with skewed, perspective, vertical
   and resampled ones; the detector's and layout parser's page maps; five
   table boxes; max|d| <= 0.1 and mean <= 1e-3 on the 0-255 scale); then,
   counted, with ParseqDataset made to raise: ``OCR(device="cuda")`` on
   demo/sample_text.png and its recognizer on the synthetic page (path
   ``ocr_page``: kernels 1-4), ``LayoutAnalyzer(device="cuda")`` with a
   DevicePage of demo/sample_table.png and the table recognizer on 4 and
   5 boxes (path ``layout_page``: kernels 3 and 5); the crop time of each
   route (ParseqDataset, the line gather) and of the region resizes (their
   float64 matmuls, with TFLOP/s), recognizer lines/s, OCR, layout
   parser, analyzer and TSR ms/page on both routes, and the device busy
   and idle share of the page route; the 400-wide width bucket forced
   (the narrow crop equal to the left slice of the full one, the routed
   lines equal to the model called at that width (path ``width_bucket``),
   batch 128 at 400 and 800 each capturing its own AR graph and each
   replay equal to an eager decode, the decode at 400 against 800, and
   kernels 1-4 and 8-9 at its shapes against their plain versions, the
   int8 block in f32 held as its card test holds it: its LayerNorm codes
   against the plain quantizer's, the 1%-of-rows rule on the sequences no
   flipped code reaches, and on every row against the plain version on
   the kernel's own codes); and the f32 recognizer,
   DBNet (u8 map within one quantum) and RT-DETRv2 from the page on the
   card against the CPU.
9. The DocumentAnalyzer path, the CUDA defaults (the page route, the int8
   memory-K/V cache): ``DocumentAnalyzer(device="cuda")`` with the four
   default models on seed-0 weights, the layout parser's and the table
   recognizer's score heads spread and balanced (utils.synthetic_heads)
   and thinned to a few tables, figures and paragraphs a page, the
   detector's map painted with the page's lines after its real forward
   (seed-0 DBNet finds one or two words a page; the ink comes from each
   DevicePage's host image, so the fused program's detector leg waits for
   nothing).  Path ``document_page``: demo/sample_table.png,
   demo/sample_text.png and the synthetic page on the fused page route
   (ops/fused_page.py, the CUDA default), counted (kernels 1-5 each
   launched), with each page's slots (the tables the host kept, slot
   hits, tables on the chunked route, saturation warnings; every kept
   table whose box a slot holds read from it, and min(tables, 4) slot hits
   wherever the host's filter kept every table the device selected); path
   ``document_unfused``: the same pages with YOMITOKU_TPU_NO_FUSED_PAGE=1,
   counted, with the same words and tables as the fused route and the
   table recognizer's scores within ROUTE_SCORE_LIMIT (cells per table,
   which bf16 rounds apart by batch size, listed); sample_table.png with
   its layout pinned to four tables (the four slots): the routes' schemas
   equal bit for bit; one fused page enqueued under
   torch.cuda.set_sync_debug_mode("error") (nothing waits for the card
   before the wire's readback) and profiled (one device-to-host copy per
   program call); each schema validated, inside its
   page and exported (JSON read back as the schema; Markdown, CSV and
   HTML, the HTML equal to ``convert_html`` of the schema);
   sample_table.png's schema equal to the detector,
   layout analyzer, recognizer, ocr_aggregate and aggregate called one at
   a time on one DevicePage; path ``document_batch``: ``batch`` of those
   pages and five cut from them at max_in_flight 4 on a freshly built
   analyzer (its AR graphs captured while other pages run), twice, each
   page equal to its own ``__call__`` on a second analyzer with the same
   weights, with the AR loop's lock held and waited seconds; the analyzer
   in f32 on the card against the CPU on the top 400 rows of
   sample_table.png, both on the fused route (equal counts, boxes within
   1 px, strings equal where the CPU's top-2 gaps are at least 1e-4); then
   ms/page on the fused, unfused and host routes, and on the fused and
   unfused routes batch pages/s at max_in_flight 1 and 4, one page's device
   busy, idle share, device ops and device-to-host copies; and the detector
   and layout analyzer on the analyzer's two
   threads against new ones and against each alone (the detector also on
   a new thread, with cuDNN on and off).
10. The CLI backend (``yomitoku_tpu_torch.cli.main``), the CUDA defaults:
   the PDF engine's host C++ (rasterizer, CCITT, JBIG2) built with g++,
   demo/sample.pdf (2 pages) and demo/sample_scan.pdf (1 CCITT page)
   rendered at 200 dpi with the port's ``load_pdf`` (3556x2667, ink on
   every page, ms/page); then ``main()`` in this process on
   demo/sample.pdf with ``-d cuda``, each analyzer the CLI builds given
   phase 9's weights and painted detector after its own construction.
   Path ``cli``: the first ``-f json`` run, counted (kernels 1-5 each
   launched, no bf16 launch on an FMA or scalar route; the fused route),
   each page's JSON equal to ``convert_json`` of that analyzer's
   ``__call__`` on the same rendered page, with each page's slots gated as
   in phase 9 and the routes compared as there, and
   on both routes ms/page, ``batch`` on its two pages at max_in_flight 1
   and 4 (pages/s) and one page profiled; then ``-f json`` again (pages/s end to end, and per
   page the construction, render, ``batch`` and export), once under
   torch.profiler (device idle share), ``-f md -v``, ``-f csv``,
   ``-f pdf`` (the searchable-PDF writer's ms), ``-f pdf --combine``
   (re-opened with the port's PdfDocument: 2 pages whose text layers hold
   every word of the JSON pages), ``-f json`` on demo/sample_scan.pdf,
   ``-f html`` (each page byte-equal to the port's ``convert_html`` of
   that analyzer's ``__call__`` on the same page, the HTML printer's ms per
   page) and ``-f html --combine`` (the pages joined); every output file
   present and not empty, under build/chip_smoke/cli/, the numbers in
   build/chip_smoke/cli.json; lxml never loaded.  ``-f json --num_devices
   2`` once: on one card the analyzer's ``batch`` takes the page axis one
   page a chunk (``batch_call`` counted) and every file equals the default
   run's.  Path ``cli_f32``: ``-f json`` with YOMITOKU_TPU_DTYPE=f32 set
   before the CLI builds its analyzer, counted (kernels 1-5 each launched,
   none on a bf16 route: attention, GEMM and convolution launches on
   "fma" only), every model in f32, each page's JSON equal to that f32
   analyzer's ``__call__``, then again timed: its pages/s beside the bf16
   CLI's.  YOMITOKU_TPU_NATIVE_DIR: a subprocess with the variable naming
   a fresh directory of hard links to the libraries already built loads
   the kernel library and the host ones from there (no build) and holds
   one kernel launch to its plain version.
11. Table semantics (``TableSemanticParser``), the CUDA defaults (the
   fused page route, with the cell detector in its region slot): the
   full-width parser (rtdetrv2v2 layout, the
   rtdetrv2_beta cell detector at 640x640 with 2,500 queries, dbnetv2_1,
   parseq-large-v4_1) with phase 9's layout, detector and recognizer
   weights and painted detector, the cell detections pinned after the real
   forward, readback and filter to a 4x4 grid or to 4 key-value rows by
   the parity of the crop's w + h, the same on both routes
   (``utils.synthetic_heads.pinned_filter_packed``).
   Path ``semantic``: one ``__call__`` on demo/sample_table.png, counted
   (kernels 1-5 each launched, the deformable kernel 6 times for the layout
   parser, 6 for the four slots and 6 per chunk of the tables the slots
   missed, no bf16 launch on an FMA or scalar route; the slots gated as in
   phase 9); path ``semantic_unfused``: the same page with
   YOMITOKU_TPU_NO_FUSED_PAGE=1, counted (6 per cell-detector chunk), with
   the same tables, grids and key-value items as the fused route; the
   fused program's sync check and device-to-host count as in phase 9; the
   schema with at least one grid and one key-value item, its
   ids in order; one cell-detector call counted alone (its decoder's
   self-attention on "wgmma"); ``batch`` of three pages at max_in_flight 1
   and 4 on the fused, the unfused and the host route, each page equal to
   its own ``__call__``; ``yomitoku_torch_extract sample_table.png -v -d cuda`` in
   process with a schema naming cells of the pinned grid and a key (written
   to build/chip_smoke/semantic/schema.yaml), its parser built by the CLI
   and given the same weights, its JSON equal to ``run_rule_extraction`` on
   that parser's own ``__call__`` and every file present and not empty; an
   f32 cell detector on the card against the CPU on a 640x640 table crop;
   then ms/page on the fused, unfused and host routes, the cell detector
   per call at 1 and 4 tables with device busy, the parse's host time, and
   on the fused and unfused routes ``batch`` pages/s at 1 and 4 in flight
   and one page's device busy, idle share, device ops and device-to-host
   copies, in build/chip_smoke/semantic.json.
12. The page axis (``parallel/``, ``FusedPageAnalysis.batch_call``, the
   analyzers' ``_batch_dp_fused``): ``DocumentAnalyzer`` on phase 9's 8
   pages and ``TableSemanticParser`` on 4 of phase 11's, each with
   ``num_devices=2`` on the one card (``dp_mesh(2)`` is None: chunks of
   ``YOMITOKU_TPU_DP_CHUNK`` pages, at 1 and 4).  Paths ``document_dp``
   and ``semantic_dp`` (both chunks, counted; routes as in phase 9); the
   ``batch_call`` page counts; one page a chunk equal to ``batch()``, bit
   for bit; four pages a chunk unpinned (the table crops the layout's
   bf16 boxes moved, counted) and with the layout pinned to four tables
   on both sides: the same words and table crops, every lane fed the
   region model ``batch()``'s crops bit for bit, the region model's
   scores on the host's rows within its own batch rounding on the same
   crops (+ 1e-6); pages/s beside ``batch()`` at max_in_flight 1 and 4,
   one run of each chunk profiled (device ops and device-to-host copies
   per page); a chunk of 4 enqueued under sync debug mode "error" and one
   copy per ``batch_call``; replicas on ``[cuda:0, cuda:0]`` (DBNet, the
   layout and table RT-DETRv2s and PARSeq split over two copies equal to
   the model on each half, and the page axis over them equal to one page
   a chunk, bit for bit); the f32 analyzer and the f32 table semantic
   parser (the layout pinned; the cell detector's scores within 1e-4) at
   four pages a chunk against ``__call__`` within phase 9's card-vs-CPU
   limits; ``DocumentAnalyzer`` under YOMITOKU_TPU_HOST_CROPS=1 on the
   stage-batched host route (``_batch_dp_host``, path
   ``document_dp_host``) against phase 9's host-route ``batch()``, the
   layout pinned: the same quads, strings apart only where the recognizer
   read a bit-equal crop otherwise in its batch, the table recognizer's
   crops and scores under the gate above; numbers in
   build/chip_smoke/dp.json.
   Phase 2 holds kernel 3 at the 16 slots' (16, 300, 256) and (16, 2500,
   256) and kernel 5 at (16, 300) and (16, 2500) for this phase.
13. Tensor parallelism (``parallel.parseq_param_shardings``,
   ``shard_params``) on ``parseq`` (D 512, 8 heads of 64, 12 blocks,
   7,310 classes; seed-0 weights, the full memory-K/V cache on every
   side): kernels 1-4 at its width (x (128, 400, 512), hidden 2048; q
   (128, 101, 512) against k/v (128, 400, 512); x (12,928, 512)) against
   their plain versions and timed as in phase 2; ``TextRecognizer(
   model_name="parseq", device="cuda")`` on phase 3's synthetic page, and
   in f32 on the card against the CPU on 16 lines (phase 3's gate); then
   the model split over the meshes [cuda:0] x 2 at tp 2 (1, 2), [cuda:0]
   x 4 at tp 2 (2, 2) and [cuda:0] x 4 at tp 4 (1, 4: the head stays
   whole, 7,310 % 4 = 2, and the embedding splits in four): the shards'
   shapes and their own storage; path ``recognizer_tp``: each mesh's rows
   decode 128 lines, counted (kernels 1-4 each launched, attention and
   GEMMs on wgmma routes), one AR graph captured per row and shape and
   replayed; in bf16 the ids equal the unsharded model's on the same
   slices outside near-ties (top-2 gap < 1e-4), in f32 equal with the
   probs within 1e-5; the first row's non-AR decode, one AR step and one
   replay enqueued under torch.cuda.set_sync_debug_mode("error"); the
   head's GEMM whole against split in two (CUDA events); lines/s of the
   unsharded model beside (1, 2) and (2, 2), in turns; numbers in
   build/chip_smoke/tp.json.
14. ``yomitoku_torch --lite`` (parseq-tiny: D 368, 8 heads of 46, patch
   (8, 16) on 32x400, 100 tokens, 51 positions; dbnetv2_1-lite at 640 /
   960) and parseq-small (D 384, 8 heads of 48, 100 tokens, 101
   positions), seed-0 weights, the full memory-K/V cache: kernels 1-4 at
   tiny's shapes (x (128, 100, 368), hidden 1472; q (128, 51, 368) against
   k/v (128, 100, 368); x (6,528, 368)) and 1 and 3 at small's, against
   their plain versions and timed as in phase 2 (in the kernels line under
   rows 1-4 as ``at.tiny`` / ``at.small``), with the attention core of 1
   and 3 on its route and on "fma" (``launch_attention``, uncounted) and
   one SDPA call; the attention output written into the first D columns
   of wider rows holding a sentinel; kernels 6 and 7 at a head dim of 46
   by phase 7's harness (with the SDPA chain and one
   F.multi_head_attention_forward call), 8 by phase 5's (``at.dh46``); then ``TextRecognizer(model_name=...)`` for both on
   phase 3's synthetic page (paths ``recognizer_tiny``,
   ``recognizer_small``: kernels 1-4 each launched, no attention launch
   on "fma"), lines/s and decode, f32 card against CPU on 16 lines (phase
   3's gate) and bf16 against f32 on the card (logits within 2e-2 of the
   largest f32 logit); then ``yomitoku_torch demo/sample.pdf --lite -f
   json`` in this process (path ``cli_lite``: kernels 1-5; the analyzer
   the CLI builds given phase 9's detector, layout and table weights, its
   detector painted), each page's JSON equal to ``convert_json`` of that
   analyzer's ``__call__``, pages/s with and without construction and per
   stage, and the f32 lite analyzer on the card against the CPU on the top
   400 rows of sample_table.png (phase 9's gate); numbers in
   build/chip_smoke/lite.json.

Phase 3 pins YOMITOKU_TPU_INT8_KV=0 (the full cache, which its f32
card-vs-CPU check compares with the CPU's), phase 6 leaves it at its
default.  The layout kernels' times are taken twice: CUDA events around one Python
call (host dispatch included) and the device time of the call's CUDA
kernels from torch.profiler.  Then one JSON line with the kernels (each with
its launches on the main paths, its bound: the larger of the bytes it must
move over 3.35 TB/s and its operations over 989 TFLOP/s bf16 or 1,979
TOP/s int8, and the time of one PyTorch call computing the same function
where there is one), and the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Long outputs (the nvcc log, the OCR and layout schemas, the layout
profile, the document exports and numbers) go to build/chip_smoke/.
"""

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "chip_smoke"

#: (kernel, route, main source, other sources, TPU kernel it replaces)
KERNELS = [
    ("fused_attention_block_ln", "cuda",
     "yomitoku_tpu_torch/csrc/attention.cu",
     ["yomitoku_tpu_torch/csrc/gemm.cu"],
     "yomitoku_tpu/ops/pallas/flash_attention.py:322"),
    ("fused_mlp_ln", "cuda", "yomitoku_tpu_torch/csrc/gemm.cu", [],
     "yomitoku_tpu/ops/pallas/fused_mlp.py:156"),
    ("fused_attention_heads", "cuda",
     "yomitoku_tpu_torch/csrc/attention.cu", [],
     "yomitoku_tpu/ops/pallas/flash_attention.py:117"),
    ("fused_mlp", "cuda", "yomitoku_tpu_torch/csrc/gemm.cu", [],
     "yomitoku_tpu/ops/pallas/fused_mlp.py:80"),
    ("ms_deformable_attention", "cuda",
     "yomitoku_tpu_torch/csrc/deformable_attention.cu", [],
     "yomitoku_tpu/ops/pallas/deformable_attention.py:100"),
    ("fused_attention_block_ln_int8", "cuda",
     "yomitoku_tpu_torch/csrc/gemm_int8.cu",
     ["yomitoku_tpu_torch/csrc/attention.cu"],
     "yomitoku_tpu/ops/pallas/flash_attention.py:436"),
    ("fused_mlp_ln_int8", "cuda", "yomitoku_tpu_torch/csrc/gemm_int8.cu", [],
     "yomitoku_tpu/ops/pallas/fused_mlp.py:264"),
    ("fused_attention", "cuda", "yomitoku_tpu_torch/csrc/attention.cu", [],
     "yomitoku_tpu/ops/pallas/flash_attention.py:51"),
    ("fused_attention_block", "cuda", "yomitoku_tpu_torch/csrc/attention.cu",
     ["yomitoku_tpu_torch/csrc/gemm.cu"],
     "yomitoku_tpu/ops/pallas/flash_attention.py:220"),
    ("fused_bottleneck", "cuda", "yomitoku_tpu_torch/csrc/bottleneck.cu", [],
     "yomitoku_tpu/ops/pallas/bottleneck.py:172"),
    ("fused_identity_stage", "cuda", "yomitoku_tpu_torch/csrc/bottleneck.cu", [],
     "yomitoku_tpu/ops/pallas/stage.py:148"),
]

# Recognizer shapes (parseq-large-v4_1, batch 128, 32x800 canvas)
B, L, D, HEADS, HIDDEN, STEPS = 128, 400, 768, 8, 3072, 101
#: the kernels each path runs
OCR_KERNELS = ("fused_attention_block_ln", "fused_mlp_ln",
               "fused_attention_heads", "fused_mlp")
LAYOUT_KERNELS = ("fused_attention_heads", "ms_deformable_attention")
INT8_KERNELS = ("fused_attention_block_ln_int8", "fused_mlp_ln_int8",
                "fused_attention_heads", "fused_mlp")
#: the card's published peaks (H100 SXM, dense; NVIDIA's H100 datasheet)
HBM_BYTES_S, BF16_FLOP_S, INT8_OP_S, F32_FLOP_S = 3.35e12, 989e12, 1979e12, 67e12
# RT-DETRv2 shapes at 640x640: the pyramid's levels, hidden 256, 8 heads of
# 32, points (4, 4, 4); queries of the layout decoder and the cell detector
LEVELS, D_DETR, POINTS = ((80, 80), (40, 40), (20, 20)), 256, (4, 4, 4)
#: (batch, Lq): the layout parser's page, the table recognizer's batch of
#: TABLE_BOXES crops, the cell detector's queries on one and four tables,
#: and the 16 slots of the page axis at four pages a chunk (phase 12)
DEFORM_QUERIES = {"lq300": (1, 300), "b4_lq300": (4, 300), "lq2500": (1, 2500),
                  "b4_lq2500": (4, 2500), "b16_lq300": (16, 300), "b16_lq2500": (16, 2500)}
#: fused_attention_heads at RT-DETR's self-attention: (batch, L of q, k and
#: v), the page and the table recognizer's batch, and the cell detector's
#: decoder over 2,500 queries on one and four tables; the page axis at
#: four pages a chunk (phase 12): the table recognizer's and the cell
#: detector's 16 slots
RTDETR_ATTENTION = {"aifi": (1, 400), "decoder": (1, 300),
                    "aifi_b4": (4, 400), "decoder_b4": (4, 300),
                    "cell_decoder": (1, 2500), "cell_decoder_b4": (4, 2500),
                    "decoder_b16": (16, 300), "cell_decoder_b16": (16, 2500)}
#: the attention shapes whose 128-row blocks fill the card: route "wgmma"
WGMMA_ATTENTION = ("cell_decoder", "cell_decoder_b4", "cell_decoder_b16")
#: the fused-backbone path's kernels
FUSED_KERNELS = ("fused_bottleneck", "fused_identity_stage")
#: fused_bottleneck at each distinct stride-1 block of DBNet (1600x1184 ->
#: layer1 400x296, layer4 100x74) and PResNet-50-d (640x640): label -> (H,
#: W, Cin, Cm, Cout, dilation, projection).  DBNet's identity blocks run
#: in the stage kernel.
BOTTLENECK_SHAPES = {
    "dbnet_layer1_0": (400, 296, 64, 64, 256, 1, True),
    "dbnet_layer4_0": (100, 74, 1024, 512, 2048, 1, True),
    "presnet_stage0_0": (160, 160, 64, 64, 256, 1, True),
    "presnet_stage0": (160, 160, 256, 64, 256, 1, False),
    "presnet_stage1": (80, 80, 512, 128, 512, 1, False),
    "presnet_stage2": (40, 40, 1024, 256, 1024, 1, False),
    "presnet_stage3": (20, 20, 2048, 512, 2048, 1, False),
}
#: fused_identity_stage at DBNet's stage tails: label -> (H, W, C, Cm, N,
#: dilation)
STAGE_SHAPES = {
    "dbnet_layer1": (400, 296, 256, 64, 2, 1),
    "dbnet_layer2": (200, 148, 512, 128, 3, 1),
    "dbnet_layer3": (100, 74, 1024, 256, 5, 1),
    "dbnet_layer4": (100, 74, 2048, 512, 2, 2),
}
#: fused_attention at the ViT's (B, H, L, Dh); fused_attention_block at the
#: AIFI's (B, L, D), 8 heads
ATTENTION_SHAPE, ATTENTION_BLOCK_SHAPE = (128, 8, 400, 96), (1, 400, 256)
#: the shape of each kernel's headline numbers in the kernels line
MAIN_SHAPE = {"ms_deformable_attention": "lq300",
              "fused_attention": "vit", "fused_attention_block": "aifi",
              "fused_bottleneck": "dbnet_layer1_0",
              "fused_identity_stage": "dbnet_layer3"}
#: CUDA kernel names (as the profiler shows them) of each wrapper
DEVICE_NAMES = {"ms_deformable_attention": "deform_gather_kernel",
                "fused_attention_heads": "attention"}
#: the deformable kernel's CUDA name, and its instantiations
#: (csrc/deformable_attention.cu): the vector route at 1, 2, 4, 8, 16 lanes
#: per tap row in bf16 and 1-32 in f32, the scalar route in each type
DEFORM_KERNEL = DEVICE_NAMES["ms_deformable_attention"]
DEFORM_INSTANTIATIONS = 13
#: fixed table boxes of demo/sample_table.png (960x1280) for the batched
#: table structure recognizer, whatever the random layout parser finds
TABLE_BOXES = [[40, 120, 920, 560], [40, 600, 920, 1180], [0, 0, 480, 640],
               [480, 640, 960, 1280]]


class SmokeFailure(RuntimeError):
    pass


@contextlib.contextmanager
def _env(**values):
    """Set (or, with None, unset) environment variables for the block."""
    old = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def bound(tensors, outputs, ops):
    """The least time the card could take: the larger of the bytes of
    ``tensors`` (read once) and ``outputs`` (written once) over the memory
    rate, and ``ops`` = {"bf16" | "int8" | "f32": count} over the peak
    rates, the parts of a mixed kernel added.  -> (ms, "bytes" or
    "operations")."""
    nbytes = sum(t.numel() * t.element_size() for t in list(tensors) + list(outputs)
                 if hasattr(t, "element_size"))
    t_bytes = nbytes / HBM_BYTES_S
    rate = {"bf16": BF16_FLOP_S, "int8": INT8_OP_S, "f32": F32_FLOP_S}
    t_ops = sum(n / rate[k] for k, n in ops.items())
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


# ------------------------------------------------------------------ phase 1


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    check(out, "nvidia-smi printed no GPU")
    return out[0].strip()


def instantiations(build_log, kernels):
    """[(kernel<template args>, registers, spill bytes)] of every kernel
    whose name matches the regex ``kernels``, in ptxas's output, in build
    order."""
    import re

    rows, name = [], None
    for line in build_log.splitlines():
        m = re.search(rf"Compiling entry function '\w*?\d({kernels})(?:I(\w+?)EEv|E)", line)
        if m:
            args = re.findall(r"Li(\d+)E|Lb([01])E|(13__nv_bfloat16|(?<!N)S\d*_)|(f)",
                              m.group(2) or "")
            label = ", ".join(n or ("true" if b == "1" else "false") if n or b else
                              "bf16" if h else "f32" for n, b, h, _ in args)
            name, spills = f"{m.group(1)}<{label}>" if m.group(2) else m.group(1), None
            continue
        if name and spills is None and "spill stores" in line:
            spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill", line))
        elif name and spills is not None and "Used" in line:
            rows.append((name, int(re.search(r"Used (\d+) registers", line).group(1)), spills))
            name = None
    return rows


def phase_card():
    import torch

    from yomitoku_tpu_torch.ops import _build

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    lib = _build.library()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {lib.build_seconds:.1f} s) -> {lib.path.name}")
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "nvcc.log").write_text(lib.build_log)
    if lib.build_log:  # a fresh build: ptxas's registers and spills
        rows = instantiations(lib.build_log, r"attention_(?:wgmma_|combine_)?kernel")
        log("attention instantiations (ptxas): " + "; ".join(
            f"{n} {r} regs, {sp} B spilled" for n, r, sp in rows))
        check(any("wgmma" in n for n, _, _ in rows), "no wgmma attention kernel was built")
        check(all(sp == 0 for _, _, sp in rows), "an attention instantiation spills")
        rows = instantiations(lib.build_log, "gemm_wgmma_kernel|gemm_f32_kernel|layer_norm_kernel")
        log("gemm instantiations (ptxas): " + "; ".join(
            f"{n} {r} regs, {sp} B spilled" for n, r, sp in rows))
        check(sum("gemm_wgmma" in n for n, _, _ in rows) == 4 * len(GEMM_SCHEDULES),
              "a wgmma GEMM schedule was not built in both weight layouts, with and "
              "without GELU")
        check(all(sp == 0 for _, _, sp in rows), "a GEMM instantiation spills")
        rows = instantiations(lib.build_log, "gemm_int8_kernel|quantize_rows_kernel")
        log("gemm_int8 instantiations (ptxas): " + "; ".join(
            f"{n} {r} regs, {sp} B spilled" for n, r, sp in rows))
        check(sum("gemm_int8" in n for n, _, _ in rows) == 4 * len(GEMM_INT8_ROUTES),
              "an int8 GEMM route was not built for both output types, with and "
              "without GELU")
        check(all(sp == 0 for _, _, sp in rows), "an int8 GEMM instantiation spills")
        rows = instantiations(lib.build_log, "conv_wgmma_kernel|conv_combine_kernel|conv_f32_kernel")
        log("conv instantiations (ptxas): " + "; ".join(
            f"{n} {r} regs, {sp} B spilled" for n, r, sp in rows))
        check(sum("conv_wgmma" in n for n, _, _ in rows) == 4,
              "a convolution unit shape (128 or 64 pixels x 128 or 64 channels) was not built")
        check(all(sp == 0 for _, _, sp in rows), "a convolution instantiation spills")
        rows = instantiations(lib.build_log, DEFORM_KERNEL)
        log("deform instantiations (ptxas): " + "; ".join(
            f"{n} {r} regs, {sp} B spilled" for n, r, sp in rows))
        check(len(rows) == DEFORM_INSTANTIATIONS,
              f"{len(rows)} deformable instantiations built, {DEFORM_INSTANTIATIONS} expected")
        check(all(sp == 0 for _, _, sp in rows), "a deformable instantiation spills")
    return card


# ------------------------------------------------------------------ phase 2


#: weight layouts held against the plain versions: the models' (their torch
#: Linear weights, row-major (out, in), passed ``.t()``) and row-major
#: (in, out).  The bf16 GEMM has one instantiation for each.
LAYOUTS = ("out_in.t", "in_out")


def stock_attn_heads(q, k, v, h):
    """SDPA on head-packed rows."""
    import torch.nn.functional as F

    b, lq, d = q.shape
    split = lambda t: t.reshape(b, -1, h, d // h).transpose(1, 2)
    o = F.scaled_dot_product_attention(split(q), split(k), split(v))
    return o.transpose(1, 2).reshape(b, lq, d)


def _kernel_cases(rng, L=L, D=D, hidden=HIDDEN, steps=STEPS):
    """name -> (plain version, stock bf16 torch ops, inputs): numpy args in
    the (in, out) layout, the indices of the weights among them, and the
    trailing non-tensor args.  ``L``: the ViT's tokens per line (400 on the
    full canvas, 200 in the 400-wide width bucket, 100 for parseq-tiny and
    -small), the refine's keys; ``D`` and ``hidden``: the model's width and
    MLP hidden size (768 and 3072 for parseq-large-v4_1, 512 and 2048 for
    parseq, 368 and 1472 for parseq-tiny, 384 and 1536 for parseq-small);
    ``steps``: the refine's queries (the labels' length + 1: 101, 51 for
    parseq-tiny)."""
    import torch.nn.functional as F

    from yomitoku_tpu_torch import ops

    def nrm(shape, std=1.0):
        return (rng.standard_normal(shape) * std).astype("float32")

    def vec(n, center=0.0, std=0.02):
        return (center + rng.standard_normal(n) * std).astype("float32")

    ws = D ** -0.5
    block = dict(
        args=[nrm((B, L, D)), vec(D, 1.0, 0.1), vec(D),
              nrm((D, D), ws), vec(D), nrm((D, D), ws), vec(D),
              nrm((D, D), ws), vec(D), nrm((D, D), ws), vec(D)],
        weights={3, 5, 7, 9}, tail=(HEADS,),
    )
    mlp_ln = dict(
        args=[nrm((B * L, D)), vec(D, 1.0, 0.1), vec(D),
              nrm((D, hidden), ws), vec(hidden), nrm((hidden, D),
                                                    hidden ** -0.5), vec(D)],
        weights={3, 5}, tail=(),
    )
    heads = dict(
        args=[nrm((B, steps, D)), nrm((B, L, D)), nrm((B, L, D))],
        weights=set(), tail=(HEADS,),
    )
    mlp = dict(
        args=[nrm((B * steps, D)), nrm((D, hidden), ws), vec(hidden),
              nrm((hidden, D), hidden ** -0.5), vec(D)],
        weights={1, 3}, tail=(),
    )

    def stock_block(x, g, bn, wq, bq, wk, bk, wv, bv, wo, bo, h):
        y = F.layer_norm(x, (x.shape[-1],), g, bn, 1e-6)
        a = stock_attn_heads(y @ wq + bq, y @ wk + bk, y @ wv + bv, h)
        return x + a @ wo + bo

    def stock_mlp(x, w1, b1, w2, b2):
        return F.gelu(x @ w1 + b1) @ w2 + b2

    def stock_mlp_ln(x, g, bn, w1, b1, w2, b2):
        return x + stock_mlp(F.layer_norm(x, (x.shape[-1],), g, bn, 1e-6),
                             w1, b1, w2, b2)

    return {
        "fused_attention_block_ln": (
            ops.fused_attention_block_ln_reference, stock_block, block),
        "fused_mlp_ln": (ops.fused_mlp_ln_reference, stock_mlp_ln, mlp_ln),
        "fused_attention_heads": (
            ops.fused_attention_heads_reference, stock_attn_heads, heads),
        "fused_mlp": (ops.fused_mlp_reference, stock_mlp, mlp),
    }


def _on_card(case, dtype, layout):
    """The case's inputs on the card; in the "out_in.t" layout each weight
    is the ``.t()`` view of a row-major (out, in) tensor."""
    import torch

    out = []
    for i, a in enumerate(case["args"]):
        t = torch.from_numpy(a).to("cuda", dtype)
        if i in case["weights"] and layout == "out_in.t":
            t = t.t().contiguous().t()
        out.append(t)
    return out


def _kernel_call(name, args, layout):
    """(function, args) of the kernel as the main path calls it.  In the
    models' layout the ViT hands ``fused_attention_block_ln_packed`` its
    packed (3D, D) qkv weight ``.t()``; row-major (in, out) weights go
    through the public ``fused_attention_block_ln``."""
    import torch

    from yomitoku_tpu_torch import ops

    if name == "fused_attention_block_ln" and layout == "out_in.t":
        x, g, bn, wq, bq, wk, bk, wv, bv, wo, bo = args
        w_in = torch.cat([wq.t(), wk.t(), wv.t()])  # (3D, D) row-major
        return ops.fused_attention_block_ln_packed, [
            x, g, bn, w_in.t(), torch.cat([bq, bk, bv]), wo, bo]
    return getattr(ops, name), args


def _held(got, want, x, rel, add, unit):
    """max|got - want| against rel * max|want| + add.  For the residual
    sublayers (x given) also the sublayer's own delta: after the output's
    rounding (``unit`` * |got|) is taken off, |got - want| must stay within
    rel * max|want - x| + add, the scale of what the sublayer adds to x
    rather than of the x it passes through.  -> (max|d|, ok, text)."""
    d = (got.float() - want).abs()
    err = d.max().item()
    limit = rel * want.abs().max().item() + add
    ok = err <= limit
    text = f"max|d| {err:.3e} (limit {limit:.3e})"
    if x is not None:
        excess = (d - unit * got.float().abs()).max().item()
        dlimit = rel * (want - x.float()).abs().max().item() + add
        ok = ok and excess <= dlimit
        text += f", delta {excess:.3e} (limit {dlimit:.3e})"
    return err, ok and math.isfinite(err), text


def kernel_ops(name, args, tail):
    """Operations of one call at these inputs, by type (multiply-adds as
    two): the projections' and MLPs' products, and attention's QK^T and PV
    (2 B H Lq Lk Dh each)."""
    if name in ("fused_attention_block_ln", "fused_attention_block_ln_int8"):
        B, L, D = args[0].shape
        proj, attn = 8 * B * L * D * D, 4 * B * L * L * D
        if name.endswith("_int8"):
            return {"int8": proj, "bf16": attn}
        return {"bf16": proj + attn}
    if name in ("fused_mlp_ln", "fused_mlp", "fused_mlp_ln_int8"):
        M, D = args[0].shape
        hidden = args[4].shape[0] if name.endswith("_int8") else args[-2].shape[0]
        return {"int8" if name.endswith("_int8") else "bf16": 4 * M * D * hidden}
    if name == "fused_attention_heads":
        B, Lq, D = args[0].shape
        return {"bf16": 4 * B * Lq * args[1].shape[1] * D}
    if name == "ms_deformable_attention":
        value, loc = args[0], args[1]
        B, Lq, nh, P = loc.shape[:4]
        return {"f32": B * Lq * nh * P * 4 * value.shape[-1] * 2}
    if name == "fused_attention":
        B, H, Lq, Dh = args[0].shape
        return {"bf16": 4 * B * H * Lq * args[1].shape[2] * Dh}
    if name == "fused_attention_block":
        B, L, D = args[0].shape
        return {"bf16": 8 * B * L * D * D + 4 * B * L * L * D}
    if name in FUSED_KERNELS:
        # one multiply-add per pixel and weight element (w1, w2, w3, wd)
        x = args[0]
        ws = [a for i, a in enumerate(args) if i in (1, 3, 5, 7) and a is not None]
        return {"bf16": 2 * (x.numel() // x.shape[-1]) * sum(w.numel() for w in ws)}
    raise KeyError(name)


def sdpa_call(q, k, v, h):
    """One scaled_dot_product_attention call on head-split views of the
    head-packed rows (the views cost nothing), and its output."""
    import torch.nn.functional as F

    b, lq, d = q.shape
    split = lambda t: t.view(b, -1, h, d // h).transpose(1, 2)  # noqa: E731
    qs, ks, vs = split(q), split(k), split(v)
    return lambda: F.scaled_dot_product_attention(qs, ks, vs)


def host_us(fn, runs=1000):
    """Host time per call of ``fn`` in microseconds: ``runs`` calls back to
    back after a warm-up, without a sync inside (what one call costs the
    host when the device keeps up), then one sync outside the clock."""
    import torch

    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    us = (time.perf_counter() - t0) / runs * 1e6
    torch.cuda.synchronize()
    return us


def loop_ms(fn, calls=50, runs=5):
    """Time per call of ``fn`` on the card: CUDA events around ``calls``
    back-to-back calls (the device's time once the host keeps ahead), the
    median of ``runs`` such loops after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def median_ms(fn, runs=10, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def profiled(fn, runs=10, warmup=True):
    """torch.profiler over ``runs`` calls of ``fn`` after one warm-up (none
    where ``warmup`` is false: ``fn`` ran warm just before) -> (wall ms per
    call, {kernel name: device ms per call}, device kernels per call,
    {kernel name: launches in the window}).  Device times are the CUDA
    kernels' own (CUPTI); the wall time ends in a sync."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warmup:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / runs
    device, launched = {}, {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            device[e.key] = (device.get(e.key, 0.0)
                             + e.self_device_time_total / 1e3 / runs)
            launched[e.key] = launched.get(e.key, 0) + e.count
    return wall, device, sum(launched.values()) / runs, launched


#: profiler windows whose launches were not a whole number per call
_ragged_windows = []


def device_ms(fn, kernel="", runs=10):
    """Device time per call of the CUDA kernels (those whose name holds
    ``kernel``, where given), or None where the profiler saw none.  Each
    kernel counts its mean time per launch times its launches per call
    (rounded): a window that lost records at its end, or took in late ones
    from the window before, shifts a count by a few, not a mean (such
    windows are listed in ``_ragged_windows`` and counted at the end)."""
    _, device, _, launched = profiled(fn, runs)
    names = [k for k in device if kernel in k]
    if any(launched[k] % runs for k in names):
        _ragged_windows.append({k[:48]: launched[k] for k in names})
    total = sum(device[k] * runs / launched[k] * round(launched[k] / runs) for k in names)
    return total or None


def route_taken(fn):
    """The attention kernel's route(s) that one call of ``fn`` launched
    ("fma", "wgmma", "wgmma_small"), or None where it launched none."""
    import torch

    from yomitoku_tpu_torch.ops._common import attention_route_launches

    before = dict(attention_route_launches)
    fn()
    torch.cuda.synchronize()
    return "+".join(r for r, n in attention_route_launches.items() if n > before[r]) or None


def attention_numbers(kern, sdpa, flops):
    """The route one call of ``kern`` takes, its device time and that of one
    SDPA call (profiler), and its TFLOP/s at ``flops``."""
    dev = device_ms(kern, "attention")
    return dict(attention_route=route_taken(kern), device_ms=dev,
                library_device_ms=device_ms(sdpa),
                tflops=None if dev is None else flops / dev / 1e9)


def log_attention(name, label, res):
    tflops = "not measured" if res["tflops"] is None else f"{res['tflops']:.1f}"
    log(f"attention {name} [{label}]: route {res['attention_route']}, device "
        f"{_ms(res['device_ms'])} against one SDPA call's "
        f"{_ms(res['library_device_ms'])}, bound {res['bound_ms']:.4f} ms "
        f"({res['bound_by']}), {tflops} TFLOP/s")


def consumer_warpgroups(name, label, q, k, v, heads):
    """The attention kernel on these bf16 inputs with two consumer
    warpgroups per block (route "wgmma", 128 rows) and with one
    ("wgmma_small" unsplit, 64 rows), launched directly (uncounted): their
    outputs held to each other (2e-2 of the largest value) and their device
    times (profiler) -> {"nwg2_device_ms": .., "nwg1_device_ms": ..}."""
    import torch

    from yomitoku_tpu_torch.ops._common import launch_attention

    scale = (q.shape[-1] // heads) ** -0.5
    outs, res = {}, {}
    for nwg, route in ((2, "wgmma"), (1, "wgmma_small")):
        out = outs[nwg] = torch.empty_like(q)
        res[f"nwg{nwg}_device_ms"] = device_ms(
            lambda: launch_attention(route, 1, q, k, v, out, heads, scale), "attention")
    err = (outs[2].float() - outs[1].float()).abs().max().item()
    top = outs[2].float().abs().max().item()
    log(f"attention consumer warpgroups {name} [{label}]: two per block (128 rows) "
        f"device {_ms(res['nwg2_device_ms'])}, one (64 rows) {_ms(res['nwg1_device_ms'])}; "
        f"outputs max|d| {err:.3e} (limit {2e-2 * top:.3e})")
    check(err <= 2e-2 * top, f"{name} [{label}]: one and two consumer warpgroups disagree")
    return res


def attention_core_routes(name, tag, bf, tail):
    """The attention kernel's core of kernel ``name`` at its bf16 inputs
    ``bf`` (kernel 3: its q, k, v; kernel 1: q, k and v as column slices of
    one (B, L, 3D) buffer, as the sublayer hands them over) on the route
    ``attention_route`` picks and on "fma" (launch_attention, uncounted):
    each held to the plain version (2e-2 of the largest value), its device
    time (profiler), and one SDPA call's -> numbers."""
    import torch

    from yomitoku_tpu_torch import ops
    from yomitoku_tpu_torch.ops._common import attention_route, launch_attention, _sm_count

    (heads,) = tail
    if name == "fused_attention_heads":
        q, k, v = bf[:3]
    else:
        x = bf[0]
        Bx, Lx, Dx = x.shape
        gen = torch.Generator(device=x.device).manual_seed(0)
        qkv = torch.randn(Bx, Lx, 3 * Dx, device=x.device, generator=gen).to(x.dtype)
        q, k, v = qkv[..., :Dx], qkv[..., Dx:2 * Dx], qkv[..., 2 * Dx:]
    Dx = q.shape[-1]
    dh = Dx // heads
    scale = dh ** -0.5
    route, splits = attention_route(q.dtype, q.dtype, q.shape[0], heads, q.shape[1], dh, True,
                                    _sm_count(q.device.index))
    want = ops.fused_attention_heads_reference(q.float(), k.float(), v.float(), heads)
    res = dict(route=route, splits=splits)
    for r, n in ((route, splits), ("fma", 1)):
        out = torch.empty_like(q)
        fn = lambda: launch_attention(r, n, q, k, v, out, heads, scale)  # noqa: E731
        fn()
        torch.cuda.synchronize()
        err = (out.float() - want).abs().max().item()
        check(err <= 2e-2 * want.abs().max().item(),
              f"{name}{tag} attention core on {r}: max|d| {err:.3e} against the plain version")
        res[f"{'fma' if r == 'fma' else 'route'}_device_ms"] = device_ms(fn, "attention")
        res[f"{'fma' if r == 'fma' else 'route'}_max_abs_err"] = err
    res["library_device_ms"] = device_ms(sdpa_call(q, k, v, heads))
    res["bound_ms"], res["bound_by"] = bound(
        [q, k, v], [q], {"bf16": 4 * q.shape[0] * q.shape[1] * k.shape[1] * Dx})
    log(f"attention core {name}{tag} q {tuple(q.shape)} k/v {tuple(k.shape)}, {heads} x {dh}: "
        f"route {route} ({splits} splits) device {_ms(res['route_device_ms'])}, \"fma\" "
        f"{_ms(res['fma_device_ms'])}, one SDPA call {_ms(res['library_device_ms'])}; bound "
        f"{res['bound_ms']:.4f} ms ({res['bound_by']}); max|d| {res['route_max_abs_err']:.3e} / "
        f"{res['fma_max_abs_err']:.3e}")
    return res


def phase_kernels(D=D, hidden=HIDDEN, tag="", layouts=LAYOUTS, seed=0, L=L, steps=STEPS,
                  names=OCR_KERNELS, fma=False):
    """Kernels ``names`` (1-4) at the recognizer's shapes of width ``D`` (MLP
    hidden ``hidden``, ``L`` tokens, ``steps`` refine queries) against
    their plain versions in ``layouts``, then timed in the models' layout
    -> {kernel: numbers}.  ``tag`` marks the lines of another width (phase
    13: "_d512"; phase 14: "_tiny", "_small").  With ``fma`` the attention
    kernel's core of kernels 1 and 3 is also timed on its "fma" route at
    the same shape (attention_core_routes)."""
    import numpy as np
    import torch

    from yomitoku_tpu_torch import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cases = _kernel_cases(np.random.default_rng(seed), D=D, hidden=hidden, L=L, steps=steps)
    results = {}
    all_layouts = layouts
    for name, (ref, stock, case) in cases.items():
        if name not in names:
            continue
        tail = case["tail"]
        res = {}
        layouts = all_layouts if case["weights"] else all_layouts[:1]
        for layout in layouts:
            f32 = _on_card(case, torch.float32, layout)
            bf = _on_card(case, torch.bfloat16, layout)
            x32, xb = (f32[0], bf[0]) if name.endswith("_ln") else (None, None)
            with torch.no_grad():
                kern, args32 = _kernel_call(name, f32, layout)
                err32, ok32, text32 = _held(
                    kern(*args32, *tail), ref(*f32, *tail), x32,
                    1e-4, 1e-5, 2.0 ** -24)
                kern, args16 = _kernel_call(name, bf, layout)
                err16, ok16, text16 = _held(
                    kern(*args16, *tail),
                    ref(*[a.float() for a in bf], *tail), xb, 2e-2, 0.0,
                    2.0 ** -8)
            torch.cuda.synchronize()
            log(f"kernel {name}{tag} [{layout}] {tuple(bf[0].shape)}: f32 {text32} "
                f"{'ok' if ok32 else 'FAIL'}; bf16 {text16} "
                f"{'ok' if ok16 else 'FAIL'}")
            check(ok32 and ok16,
                  f"{name}{tag} [{layout}] disagrees with its plain version")
            suffix = "" if layout == LAYOUTS[0] else "_" + layout
            res["max_abs_err" + suffix] = err16
            res["max_abs_err_f32" + suffix] = err32
            if layout == LAYOUTS[0]:  # timed in the main path's layout
                with torch.no_grad():
                    out16 = kern(*args16, *tail)
                    res["ms"] = median_ms(lambda: kern(*args16, *tail))
                    res["plain_ms"] = median_ms(lambda: ref(*bf, *tail))
                    res["stock_ms"] = median_ms(lambda: stock(*bf, *tail))
                    res["library_ms"] = (
                        median_ms(sdpa_call(*bf, *tail))
                        if name == "fused_attention_heads" else None)
                    res["device_ms"] = device_ms(lambda: kern(*args16, *tail))
                    res["stock_device_ms"] = device_ms(lambda: stock(*bf, *tail))
                res["bound_ms"], res["bound_by"] = bound(
                    bf, [out16], kernel_ops(name, bf, tail))
                if name == "fused_attention_heads":  # the PARSeq refine
                    with torch.no_grad():
                        res.update(attention_numbers(
                            lambda: kern(*args16, *tail), sdpa_call(*bf, *tail),
                            kernel_ops(name, bf, tail)["bf16"]))
                        res.update(consumer_warpgroups(name, "refine" + tag, *args16[:3],
                                                       *tail))
                    log_attention(name, "refine" + tag, res)
                if fma and name in ("fused_attention_heads", "fused_attention_block_ln"):
                    res["core"] = attention_core_routes(name, tag, bf, tail)
                log(f"kernel {name}{tag}: bf16 {res['ms']:.3f} ms per call (device "
                    f"{_ms(res['device_ms'])}), plain {res['plain_ms']:.3f} ms, stock "
                    f"bf16 torch {res['stock_ms']:.3f} ms (device "
                    f"{_ms(res['stock_device_ms'])}), one library call "
                    f"{res['library_ms'] if res['library_ms'] is None else round(res['library_ms'], 4)} ms "
                    f"(median of 10); bound {res['bound_ms']:.4f} ms "
                    f"({res['bound_by']})")
                del out16
            del f32, bf, args32, args16, x32, xb
            torch.cuda.empty_cache()
        results[name] = res
    ops.reset_launches()
    return results



# ------------------------------------------------------------ the GEMM kernel

#: The bf16 GEMMs of the main paths: label -> (M, K, N, epilogue), the
#: epilogue as the path runs it ("ln": the LayerNorm pass first; "gelu";
#: "res": the residual): the ViT's four per encoder block at batch 128,
#: the refine MLP's two, and fused_attention_block's two at (1, 400, 256)
GEMM_SHAPES = {
    "vit_qkv": (B * L, D, 3 * D, ("ln",)),
    "vit_out": (B * L, D, D, ("res",)),
    "vit_fc1": (B * L, D, HIDDEN, ("ln", "gelu")),
    "vit_fc2": (B * L, HIDDEN, D, ("res",)),
    "vit_qkv_b1": (L, D, 3 * D, ("ln",)),
    "vit_out_b1": (L, D, D, ("res",)),
    "refine_fc1": (B * STEPS, D, HIDDEN, ("gelu",)),
    "refine_fc2": (B * STEPS, HIDDEN, D, ()),
    "block_qkv": (400, 256, 768, ()),
    "block_out": (400, 256, 256, ()),
}
#: the GEMM shapes inside each kernel row
GEMMS_OF = {"fused_attention_block_ln": ("vit_qkv", "vit_out", "vit_qkv_b1", "vit_out_b1"),
            "fused_mlp_ln": ("vit_fc1", "vit_fc2"),
            "fused_mlp": ("refine_fc1", "refine_fc2"),
            "fused_attention_block": ("block_qkv", "block_out")}
#: the bf16 routes timed against each other at every shape
GEMM_SCHEDULES = ("wgmma", "wgmma_small")
#: The int8 GEMMs of the W8A8 sublayers: label -> (M, K, K-chunks, N,
#: epilogue, output dtype): fused_attention_block_ln_int8's QKV and
#: out-projection at batch 128 and 1, fused_mlp_ln_int8's fc1 (f32 GELU
#: output, which the chunked row-quantize pass reads) and fc2 (K in three
#: chunks of 1024)
INT8_GEMM_SHAPES = {
    "qkv": (B * L, D, 1, 3 * D, ("bias",), "bfloat16"),
    "out": (B * L, D, 1, D, ("bias", "res"), "bfloat16"),
    "fc1": (B * L, D, 1, HIDDEN, ("bias", "gelu"), "float32"),
    "fc2": (B * L, HIDDEN, 3, D, ("bias", "res"), "bfloat16"),
    "qkv_b1": (L, D, 1, 3 * D, ("bias",), "bfloat16"),
    "out_b1": (L, D, 1, D, ("bias", "res"), "bfloat16"),
}
#: The row-quantize kernel's shapes: label -> (M, K, K-chunks, input
#: dtype, LayerNorm first): the sublayers' bf16 input (QKV and fc1), the
#: f32 attention output (out-projection) and the f32 GELU output (fc2)
QUANTIZE_SHAPES = {
    "ln_x": (B * L, D, 1, "bfloat16", True),
    "attn": (B * L, D, 1, "float32", False),
    "gelu": (B * L, HIDDEN, 3, "float32", False),
}
#: the int8 GEMM and row-quantize shapes inside each kernel row
INT8_GEMMS_OF = {
    "fused_attention_block_ln_int8": (("qkv", "out", "qkv_b1", "out_b1"), ("ln_x", "attn")),
    "fused_mlp_ln_int8": (("fc1", "fc2"), ("ln_x", "gelu")),
}
#: the int8 routes (ops/_common.py GEMM_INT8_ROUTES)
GEMM_INT8_ROUTES = ("wgmma", "wgmma_m64", "wgmma_coop")


def _gemm_inputs(rng, M, K, N, epilogue, layout):
    """bf16 inputs on the card: a, w (in the layout), bias, res, ln."""
    import torch

    def dev(shape, std=1.0, center=0.0):
        return torch.from_numpy((center + rng.standard_normal(shape, dtype="float32") * std)).to(
            "cuda", torch.bfloat16)

    a = dev((M, K))
    w = dev((K, N), K ** -0.5)
    if layout == "out_in.t":
        w = w.t().contiguous().t()
    res = dev((M, N)) if "res" in epilogue else None
    ln = (dev((K,), 0.1, 1.0), dev((K,), 0.1), 1e-6) if "ln" in epilogue else None
    return a, w, dev((N,), 0.1), res, ln


def _gemm_plain(a, w, bias, res, ln, gelu):
    """The f32 product of the same bf16 values, LN(a) rounded to bf16 first
    (as the kernel and the Pallas kernels round it)."""
    import torch.nn.functional as F

    from yomitoku_tpu_torch import ops

    x = a if ln is None else ops.layer_norm(a, *ln)
    y = x.float() @ w.float() + bias.float()
    if gelu:
        y = F.gelu(y)
    return y if res is None else y + res.float()


def gemm_route_of(fn):
    """The GEMM route(s) that one call of ``fn`` launched."""
    import torch

    from yomitoku_tpu_torch.ops._common import gemm_route_launches

    before = dict(gemm_route_launches)
    fn()
    torch.cuda.synchronize()
    return "+".join(r for r, n in gemm_route_launches.items() if n > before[r]) or None


def phase_gemm():
    """The GEMM kernel at every shape of the main paths, in both weight
    layouts, with the epilogue the path runs: the route, max|d| against the
    f32 plain product of the same bf16 values (2e-2 of the largest value),
    device ms (profiler, the GEMM kernel alone), TFLOP/s, the bound, and
    one torch.matmul at the same (M, K, N) as cuBLAS's yardstick (never
    called by the port), and both bf16 schedules on the same inputs ->
    {label: numbers}."""
    import numpy as np
    import torch

    from yomitoku_tpu_torch.ops._common import gemm, launch_gemm

    rng = np.random.default_rng(3)
    results = {}
    for label, (M, K, N, epilogue) in GEMM_SHAPES.items():
        gelu = "gelu" in epilogue
        flops = 2 * M * K * N
        res_by_layout = {}
        for layout in LAYOUTS:
            a, w, bias, res, ln = _gemm_inputs(rng, M, K, N, epilogue, layout)
            out = torch.empty((M, N), dtype=torch.bfloat16, device="cuda")
            call = lambda: gemm(a, w, bias, out, res=res, ln=ln, gelu=gelu)  # noqa: E731
            route = gemm_route_of(call)
            want = _gemm_plain(a, w, bias, res, ln, gelu)
            err = (out.float() - want).abs().max().item()
            limit = 2e-2 * want.abs().max().item()
            del want
            check(math.isfinite(err) and err <= limit,
                  f"gemm [{label}, {layout}]: max|d| {err:.3e} over {limit:.3e}")
            check(route is not None and route.startswith("wgmma"),
                  f"gemm [{label}, {layout}]: bf16 took route {route}")
            r = dict(route=route, max_abs_err=err, limit=limit)
            r["device_ms"] = device_ms(call, "gemm_wgmma")
            r["tflops"] = flops / r["device_ms"] / 1e9 if r["device_ms"] else None
            if layout == LAYOUTS[0]:
                r["matmul_device_ms"] = device_ms(lambda: torch.matmul(a, w))
                r["bound_ms"], r["bound_by"] = bound(
                    [a, w, bias] + [t for t in (res,) + (ln or ())[:2] if t is not None],
                    [out], {"bf16": flops})
                for sched in GEMM_SCHEDULES:  # the route taken is timed above
                    r[f"{sched}_device_ms"] = r["device_ms"] if sched == route else device_ms(
                        lambda: launch_gemm(sched, a, w, bias, out, res, ln, gelu),
                        "gemm_wgmma")
            res_by_layout[layout] = r
            del a, w, bias, res, ln, out
            torch.cuda.empty_cache()
        main, other = res_by_layout[LAYOUTS[0]], res_by_layout[LAYOUTS[1]]
        tf = "not measured" if main["tflops"] is None else f"{main['tflops']:.1f}"
        log(f"gemm [{label}] M {M} K {K} N {N} {'+'.join(epilogue) or 'bias'}: route "
            f"{main['route']} / {other['route']} ({'/'.join(LAYOUTS)}), max|d| "
            f"{main['max_abs_err']:.3e} / {other['max_abs_err']:.3e} (limit "
            f"{main['limit']:.3e}); device {_ms(main['device_ms'])} / "
            f"{_ms(other['device_ms'])}, {tf} TFLOP/s ({flops / 1e9:.1f} GFLOP) against one "
            f"torch.matmul's {_ms(main['matmul_device_ms'])}; bound {main['bound_ms']:.4f} ms "
            f"({main['bound_by']})")
        log(f"gemm schedules [{label}]: " + ", ".join(
            f"{s} {_ms(main[s + '_device_ms'])}" for s in GEMM_SCHEDULES))
        results[label] = dict(main, **{f"{k}_{LAYOUTS[1]}": v for k, v in other.items()
                                       if k in ("route", "max_abs_err", "device_ms", "tflops")})
    return results


def check_gemm_routes(what, runs_gemm=True):
    """After a bf16 path's counted run: the GEMM kernel's launches by route;
    none on "fma" (the f32 kernel), and some on a wgmma route where the
    path runs the GEMM (``runs_gemm``; the layout path does not)."""
    from yomitoku_tpu_torch.ops._common import gemm_route_launches

    routes = dict(gemm_route_launches)
    log(f"{what}: gemm launches by route {routes}")
    check(routes["fma"] == 0 and (sum(routes.values()) > 0) == runs_gemm,
          f"{what}: the path's GEMM launches by route are off: {routes}")


def _stock_deformable(value, loc, att, shapes, points):
    """The reference torch formulation: F.grid_sample per level (bilinear,
    zeros padding, align_corners=False) at 2 * loc - 1."""
    import torch.nn.functional as F

    B, _, nh, c = value.shape
    Lq = loc.shape[1]
    out, start, p0 = 0, 0, 0
    for (h, w), P in zip(shapes, points):
        v = value[:, start:start + h * w].permute(0, 2, 3, 1).reshape(B * nh, c, h, w)
        grid = (2 * loc[:, :, :, p0:p0 + P] - 1).permute(0, 2, 1, 3, 4)
        s = F.grid_sample(v, grid.reshape(B * nh, Lq, P, 2), mode="bilinear",
                          padding_mode="zeros", align_corners=False)
        a = att[:, :, :, p0:p0 + P].permute(0, 2, 1, 3).reshape(B * nh, 1, Lq, P)
        out = out + (s * a).sum(-1)  # (B * nh, c, Lq)
        start, p0 = start + h * w, p0 + P
    return out.reshape(B, nh * c, Lq).transpose(1, 2)


def _layout_kernel_cases(rng):
    """(kernel, label) -> (plain version, stock torch op, numpy args,
    trailing non-tensor args)."""
    from yomitoku_tpu_torch import ops

    cases = {}
    nh, c = 8, D_DETR // 8
    len_v = sum(h * w for h, w in LEVELS)
    for label, (b, lq) in DEFORM_QUERIES.items():
        att = rng.random((b, lq, nh, sum(POINTS))).astype("float32")
        cases[("ms_deformable_attention", label)] = (
            ops.ms_deformable_attention_reference, _stock_deformable,
            [rng.standard_normal((b, len_v, nh, c)).astype("float32"),
             # some taps off the map, as the decoder's offsets give
             (rng.random((b, lq, nh, sum(POINTS), 2)) * 1.3 - 0.15).astype("float32"),
             att / att.sum(-1, keepdims=True)],
            (LEVELS, POINTS))
    for label, (b, n) in RTDETR_ATTENTION.items():
        cases[("fused_attention_heads", label)] = (
            ops.fused_attention_heads_reference, stock_attn_heads,
            [rng.standard_normal((b, n, D_DETR)).astype("float32")
             for _ in range(3)], (HEADS,))
    return cases


def phase_layout_kernels(names=None, own=True):
    """The layout path's kernels at RT-DETR's shapes (``names``: only
    these) -> {kernel: {label: numbers}}.  The stock op is also held to the
    plain version in f32, as an independent check of the plain version's
    semantics.  ``own``: the package is this checkout's; another commit's
    may name its kernels otherwise and lack the route counters, so there the
    device time is every kernel of the call and the deformable kernel's
    route lines are left out."""
    import numpy as np
    import torch

    from yomitoku_tpu_torch import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    for (name, label), (ref, stock, args, tail) in _layout_kernel_cases(
            np.random.default_rng(1)).items():
        if names and name not in names:
            continue
        kern = getattr(ops, name)
        f32 = [torch.from_numpy(a).cuda() for a in args]
        bf = [a.to(torch.bfloat16) for a in f32]
        with torch.no_grad():
            want32 = ref(*f32, *tail)
            err32, ok32, text32 = _held(kern(*f32, *tail), want32, None,
                                        1e-4, 1e-5, 0.0)
            err16, ok16, text16 = _held(kern(*bf, *tail),
                                        ref(*[a.float() for a in bf], *tail),
                                        None, 2e-2, 0.0, 0.0)
            _, oks, texts = _held(stock(*f32, *tail), want32, None, 1e-4,
                                  1e-5, 0.0)
        torch.cuda.synchronize()
        log(f"kernel {name} [{label}]: f32 {text32} {'ok' if ok32 else 'FAIL'}; "
            f"bf16 {text16} {'ok' if ok16 else 'FAIL'}; stock f32 vs plain "
            f"{texts} {'ok' if oks else 'FAIL'}")
        check(ok32 and ok16 and oks, f"{name} [{label}] disagrees with its plain version")
        with torch.no_grad():
            out16 = kern(*bf, *tail)
            if name == "ms_deformable_attention":
                bounds = deform_bound(bf, out16, *tail)
            else:
                bounds = dict(zip(("bound_ms", "bound_by"),
                                  bound(bf, [out16], kernel_ops(name, bf, tail))))
            res = dict(
                max_abs_err=err16, max_abs_err_f32=err32, **bounds,
                library_ms=(median_ms(sdpa_call(*bf, *tail))
                            if name == "fused_attention_heads" else None),
                ms=median_ms(lambda: kern(*bf, *tail)),
                plain_ms=median_ms(lambda: ref(*bf, *tail)),
                stock_ms=median_ms(lambda: stock(*bf, *tail)),
                device_ms=device_ms(lambda: kern(*bf, *tail), DEVICE_NAMES[name] if own else ""),
                plain_device_ms=device_ms(lambda: ref(*bf, *tail)),
                stock_device_ms=device_ms(lambda: stock(*bf, *tail)),
            )

        if name == "fused_attention_heads":
            with torch.no_grad():
                res.update(attention_numbers(lambda: kern(*bf, *tail), sdpa_call(*bf, *tail),
                                             kernel_ops(name, bf, tail)["bf16"]))
            log_attention(name, label, res)
            check(label not in WGMMA_ATTENTION or res["attention_route"] == "wgmma",
                  f"{name} [{label}]: route {res['attention_route']} (wgmma expected)")
        else:
            with torch.no_grad():
                res.update(deform_numbers(label, ref, f32, bf, tail, res, own))

        def ms(key):
            return "not measured" if res[key] is None else f"{res[key]:.4f} ms"

        log(f"kernel {name} [{label}]: per call (CUDA events, median of 10): "
            f"bf16 {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, stock "
            f"bf16 torch {res['stock_ms']:.4f} ms; on the device (profiler, all "
            f"kernels of the call): {ms('device_ms')}, plain "
            f"{ms('plain_device_ms')}, stock {ms('stock_device_ms')}")
        results.setdefault(name, {})[label] = res
        del f32, bf
        torch.cuda.empty_cache()
    ops.reset_launches()
    return results


def deform_tap_bytes(value, loc):
    """Bytes of the tap rows one deformable call reads: B Lq nh P points x 4
    taps x c channels of value's itemsize."""
    B, Lq, nh, P = loc.shape[:4]
    return B * Lq * nh * P * 4 * value.shape[-1] * value.element_size()


def deform_needed(value, loc, att, shapes, points):
    """What ms_deformable_attention needs at these inputs: (distinct
    (batch, value row, head) rows, taps) of the bilinear corners that lie
    on their level's map with a weight (bilinear x attention) other than 0.
    A corner off the map, or of a NaN location, contributes nothing."""
    import torch

    B, len_v, nh, _ = value.shape
    batch = torch.arange(B, device=value.device).view(B, 1, 1, 1)
    head = torch.arange(nh, device=value.device).view(1, 1, nh, 1)
    keys, taps, start, p0 = [], 0, 0, 0
    for (h, w), n in zip(shapes, points):
        px = loc[:, :, :, p0:p0 + n, 0].float() * w - 0.5
        py = loc[:, :, :, p0:p0 + n, 1].float() * h - 0.5
        a = att[:, :, :, p0:p0 + n].float()
        x0, y0 = torch.floor(px), torch.floor(py)
        for dy in (0, 1):
            for dx in (0, 1):
                xi, yi = x0 + dx, y0 + dy
                wt = (1 - (px - x0 - dx).abs()) * (1 - (py - y0 - dy).abs()) * a
                need = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1) & (wt != 0)
                row = start + yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
                keys.append(((batch * len_v + row) * nh + head)[need])
                taps += int(need.sum())
        start += h * w
        p0 += n
    return int(torch.unique(torch.cat(keys)).numel()), taps


def deform_bound(args, out, shapes, points):
    """ms_deformable_attention's bound at these inputs: the value rows its
    taps need (``deform_needed``), the locations and weights read once and
    the output written once over the memory rate, against its needed taps'
    multiply-adds over the f32 rate; beside it the bound with all of value
    read, for comparison with records that used that one."""
    value, loc, att = args
    rows, taps = deform_needed(value, loc, att, shapes, points)
    row_bytes = value.shape[-1] * value.element_size()
    t_bytes = (rows * row_bytes + sum(t.numel() * t.element_size() for t in (loc, att, out))
               ) / HBM_BYTES_S
    t_ops = taps * value.shape[-1] * 2 / F32_FLOP_S
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_rows=rows, value_rows=value.numel() // value.shape[-1],
                bound_taps=taps,
                bound_all_rows_ms=bound(args, [out], {"f32": taps * value.shape[-1] * 2})[0])


def deform_route_of(fn):
    """The deformable kernel's route(s) that one call of ``fn`` launched, or
    None where it launched none."""
    import torch

    from yomitoku_tpu_torch.ops._common import deform_route_launches

    before = dict(deform_route_launches)
    fn()
    torch.cuda.synchronize()
    return "+".join(r for r, n in deform_route_launches.items() if n > before[r]) or None


@contextlib.contextmanager
def plan_per_call():
    """Inside the block the deformable wrapper builds its level plan on
    every call (its cache bypassed), for a paired host-time measurement of
    the cache."""
    from yomitoku_tpu_torch.ops import deformable_attention as da

    cached, da._plan = da._plan, da._plan.__wrapped__
    try:
        yield
    finally:
        da._plan = cached


def deform_numbers(label, ref, f32, bf, tail, res, own=True):
    """ms_deformable_attention's own numbers at one shape, beside ``res``
    (phase_layout_kernels'): the tap bytes and the achieved tap GB/s of the
    bf16 device time, the f32 device and per-call times, the host time of
    one bf16 call; on this checkout's package (``own``) also the routes of
    the bf16 and f32 calls (bf16 at c = 32 must take "vector"), the host
    time with the level plan built per call (the cache bypassed; measured
    cached, per call, per call, cached), and the scalar route on the same
    bf16 values passed as a view one element off 16-byte alignment: held to
    the plain version (2e-2 of the largest value) and timed."""
    import torch

    from yomitoku_tpu_torch import ops

    kern = ops.ms_deformable_attention
    taps = deform_tap_bytes(bf[0], bf[1])
    dev = res["device_ms"]
    out = dict(
        tap_bytes=taps, tap_gb_s=None if dev is None else taps / dev / 1e6,
        device_ms_f32=device_ms(lambda: kern(*f32, *tail), DEFORM_KERNEL if own else ""),
        ms_f32=median_ms(lambda: kern(*f32, *tail)),
    )
    gbs = "not measured" if out["tap_gb_s"] is None else f"{out['tap_gb_s']:.1f} GB/s"
    text = (f"kernel ms_deformable_attention [{label}]: device {_ms(dev)} bf16 / "
            f"{_ms(out['device_ms_f32'])} f32, per call {res['ms']:.4f} / "
            f"{out['ms_f32']:.4f} ms, against the bound {res['bound_ms']:.4f} ms "
            f"({res['bound_by']}: {res['bound_rows']} of {res['value_rows']} value rows "
            f"needed; {res['bound_all_rows_ms']:.4f} ms with all of value); tap reads "
            f"{taps / 1e6:.2f} MB bf16 at {gbs}")
    if not own:
        out["host_us"] = host_us(lambda: kern(*bf, *tail))
        log(f"{text}; host {out['host_us']:.1f} us per call (enqueue, no sync)")
        return out
    v = bf[0]
    off = torch.empty(v.numel() + 1, dtype=v.dtype, device=v.device)[1:].view(v.shape)
    off.copy_(v)
    scalar = [off, *bf[1:]]
    hosts, uncached = [], []
    for cached in (True, False, False, True):
        with contextlib.nullcontext() if cached else plan_per_call():
            (hosts if cached else uncached).append(host_us(lambda: kern(*bf, *tail)))
    out.update(
        deform_route=deform_route_of(lambda: kern(*bf, *tail)),
        deform_route_f32=deform_route_of(lambda: kern(*f32, *tail)),
        deform_route_offset=deform_route_of(lambda: kern(*scalar, *tail)),
        scalar_device_ms=device_ms(lambda: kern(*scalar, *tail), DEFORM_KERNEL),
        host_us=statistics.mean(hosts), host_us_plan_per_call=statistics.mean(uncached),
        host_us_runs=hosts, host_us_plan_per_call_runs=uncached,
    )
    err, ok, held = _held(kern(*scalar, *tail), ref(*[a.float() for a in bf], *tail),
                          None, 2e-2, 0.0, 0.0)
    out["scalar_max_abs_err"] = err
    log(f"{text}; route {out['deform_route']} (f32 {out['deform_route_f32']}); host "
        f"{' / '.join(f'{h:.1f}' for h in hosts)} us per call (enqueue, no sync), "
        f"{' / '.join(f'{h:.1f}' for h in uncached)} with the level plan built per call; "
        f"route {out['deform_route_offset']} with value one element off: device "
        f"{_ms(out['scalar_device_ms'])}, bf16 {held} {'ok' if ok else 'FAIL'}")
    check(out["deform_route"] == "vector" and out["deform_route_offset"] == "scalar" and ok,
          f"ms_deformable_attention [{label}]: routes {out['deform_route']} / "
          f"{out['deform_route_offset']} (vector / scalar expected), scalar route {held}")
    return out


def check_deform_routes(what, launched):
    """After a bf16 RT-DETR path's counted run (``launched`` deformable
    launches, 6 per RT-DETR call): every deformable launch on the vector
    route (c = 32 in bf16 is whole 16-byte pieces), none on the scalar one."""
    from yomitoku_tpu_torch.ops._common import deform_route_launches

    routes = dict(deform_route_launches)
    log(f"{what}: deformable launches by route {routes}")
    check(routes["scalar"] == 0 and routes["vector"] == launched > 0 and launched % 6 == 0,
          f"{what}: the bf16 deformable launches left the vector route: {routes} "
          f"of {launched}")


# ------------------------------------------------------------------ phase 3


def check_attention_routes(what, route=None):
    """After a bf16 path's counted run: the attention kernel's launches by
    route; every one on a wgmma route (none on the FMA kernel), ``route``
    among them where given."""
    from yomitoku_tpu_torch.ops._common import attention_route_launches

    routes = dict(attention_route_launches)
    log(f"{what}: attention launches by route {routes}")
    wgmma = routes[route] if route else routes["wgmma"] + routes["wgmma_small"]
    check(routes["fma"] == 0 and wgmma > 0,
          f"{what}: the bf16 path's attention left the wgmma routes: {routes}")


def synthetic_lines_page(n_lines=136, seed=0, chars=(8, 40)):
    """A white page of ``n_lines`` printed lines (numpy + cv2) and one quad
    per line: enough for a full recognizer batch of 128 whatever the
    random detector finds.  Each line holds ``chars`` = (fewest, most + 1)
    characters, per line or as one pair for all."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(seed)
    alphabet = np.array(list("ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"))
    pitch, width = 28, 900
    page = np.full((n_lines * pitch + 16, width, 3), 255, np.uint8)
    quads = []
    spans = chars if isinstance(chars, list) else [chars] * n_lines
    for i in range(n_lines):
        text = "".join(rng.choice(alphabet, rng.integers(*spans[i])))
        y = 8 + i * pitch
        cv2.putText(page, text, (10, y + 20), cv2.FONT_HERSHEY_SIMPLEX, 0.7,
                    (0, 0, 0), 2)
        x1 = min(width - 1, 16 + 17 * len(text))
        quads.append([[6, y], [x1, y], [x1, y + pitch - 2], [6, y + pitch - 2]])
    return page, quads


def interleaved(fns, runs=5):
    """Median host wall time (s) of each of ``fns`` (key -> fn), each ending
    in a device sync, after one warm-up call each: the calls run in turns,
    so that a comparison's sides share the host's noise."""
    import torch

    times = {k: [] for k in fns}
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    for _ in range(runs):
        for k, fn in fns.items():
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[k].append(time.perf_counter() - t0)
    return {k: statistics.median(v) for k, v in times.items()}


def host_timed(fn, runs=3):
    """Median host wall time (s) of ``fn`` ending in a device sync."""
    import torch

    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def decode_profile(model, crops):
    """One recognizer model's decode of ``crops`` under torch.profiler (2
    calls) -> (device busy ms per batch, of which the attention kernels, of
    which the bf16 GEMM kernel and its LayerNorm pass, of which the int8
    GEMM kernel and its row-quantize passes)."""
    _, device, _, _ = profiled(lambda: model.forward_tokens(crops), runs=2)
    share = lambda *names: sum(v for k, v in device.items()  # noqa: E731
                               if any(n in k for n in names))
    return (sum(device.values()), share("attention"),
            share("gemm_wgmma", "layer_norm_kernel"),
            share("gemm_int8_kernel", "quantize_rows_kernel"))


def _finite_schema(schema, what):
    import math

    check(all(math.isfinite(s) for s in schema.scores), f"{what}: scores not finite")


def f32_card_vs_cpu_logits(got, want, what="f32"):
    """The gate of the f32 recognizer on the card against the CPU (logits
    on the host): greedy ids equal wherever the CPU's top-2 gap is at least
    1e-4, and the probability of the CPU's greedy id within 1e-3 -> the
    line to log."""
    import torch

    check(torch.isfinite(got).all().item(), f"{what} card logits not finite")
    top2 = want.topk(2, dim=-1).values
    tie = (top2[..., 0] - top2[..., 1]) < 1e-4
    ids_g, ids_w = got.argmax(-1), want.argmax(-1)
    differ = ids_g != ids_w
    check(not (differ & ~tie).any().item(),
          f"{what} greedy ids differ at {int((differ & ~tie).sum())} positions "
          "with a top-2 gap >= 1e-4")
    p_g = torch.exp(got.gather(-1, ids_w[..., None])[..., 0] - got.logsumexp(-1))
    p_w = torch.exp(want.gather(-1, ids_w[..., None])[..., 0] - want.logsumexp(-1))
    dp = (p_g - p_w).abs().max().item()
    check(dp <= 1e-3, f"{what} probs differ by {dp:.3e} > 1e-3")
    return (f"ids equal at {int((~differ).sum())}/{differ.numel()} positions, "
            f"{int(tie.sum())} near-tie positions (top-2 gap < 1e-4) exempt, "
            f"{int(differ.sum())} differ; max|d prob| {dp:.3e}; max|d logit| "
            f"{(got - want).abs().max().item():.3e}")


def phase_slice(card):
    """The OCR path with the full memory-K/V cache -> (launches, the
    synthetic page, its quads, 128 crops and their bf16 greedy ids)."""
    with _env(YOMITOKU_TPU_INT8_KV="0", YOMITOKU_TPU_INT8_ENCODER=None,
              YOMITOKU_TPU_HOST_CROPS="1"):
        return _phase_slice(card)


def _phase_slice(card):
    import cv2
    import numpy as np
    import torch

    from yomitoku_tpu_torch import ops
    from yomitoku_tpu_torch.data.dataset import ParseqDataset
    from yomitoku_tpu_torch.ocr import OCR
    from yomitoku_tpu_torch.text_recognizer import TextRecognizer

    t0 = time.perf_counter()
    ocr = OCR(device="cuda")  # dbnetv2_1 + parseq-large-v4_1, seed-0 weights
    det, rec = ocr.detector.model, ocr.recognizer.model
    log(f"slice: OCR(device='cuda') built in {time.perf_counter() - t0:.1f} s: "
        f"DBNet {det.param_count():,} params, PARSeq {rec.param_count():,} "
        f"params, {rec.dtype}, weights "
        f"{rec.pretrained_source or 'seed-0 random'}")
    sample = cv2.imread(str(ROOT / "demo" / "sample_text.png"))
    check(sample is not None, "demo/sample_text.png missing")
    lines_page, quads = synthetic_lines_page()

    # the main path, counted: OCR on the sample page, then the recognizer on
    # the synthetic page (one full batch of 128 + a bucket-8 remainder)
    ops.reset_launches()
    result, vis = ocr(sample)
    lines, _ = ocr.recognizer(lines_page, quads)
    check(vis is None, "OCR without visualize returned a picture")
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    log(f"slice: launches {launches}")
    check(all(launches[k] > 0 for k in OCR_KERNELS),
          f"a kernel of the OCR path was never launched: {launches}")
    check_attention_routes("slice", "wgmma")
    check_gemm_routes("slice")
    check(len(result.words) > 0, "OCR schema holds no words")
    for w in result.words:
        check(np.isfinite([w.det_score, w.rec_score]).all(), "OCR score not finite")
    _finite_schema(lines, "recognizer")
    check(len(lines.contents) == len(quads),
          f"recognizer returned {len(lines.contents)} of {len(quads)} lines")
    log(f"slice: OCR on sample_text.png {sample.shape[1]}x{sample.shape[0]}: "
        f"{len(result.words)} words; recognizer on the synthetic page: "
        f"{len(lines.contents)} lines, first {lines.contents[0][:20]!r}")
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "ocr_sample.json").write_text(result.model_dump_json(indent=1))

    # throughput (reported, not gated)
    page_s = host_timed(lambda: ocr(sample))
    det_s = host_timed(lambda: ocr.detector(sample))
    rec_s = host_timed(lambda: ocr.recognizer(lines_page, quads[:128]))
    def crop():
        return ParseqDataset(ocr.recognizer._cfg, lines_page, quads[:128]).as_u8_array()

    crop_s = host_timed(crop)
    crops = crop()
    rec._ar_loops.clear()  # the next call builds the batch-128 AR state anew
    first_s = host_timed(lambda: rec.forward_tokens(crops), runs=1)
    ids_bf16, _ = rec.forward_tokens(crops)
    model_s = host_timed(lambda: rec.forward_tokens(crops))
    busy, attn, gemm_ms, _ = decode_profile(rec, crops)
    log(f"slice: bf16 decode {model_s * 1e3:.1f} ms per batch of 128; on the device "
        f"(profiler) busy {busy:.2f} ms, of which the attention kernel {attn:.3f} ms "
        f"and the GEMM kernel with its LayerNorm pass {gemm_ms:.3f} ms "
        f"({gemm_ms / busy:.3f} of busy)")
    log(f"slice: OCR {page_s * 1e3:.1f} ms/page (detector {det_s * 1e3:.1f} ms) "
        f"on sample_text.png; recognizer bf16 batch 128: {128 / rec_s:.1f} "
        f"lines/s end to end ({rec_s * 1e3:.1f} ms, of which host crops "
        f"{crop_s * 1e3:.1f} ms), {128 / model_s:.1f} lines/s device decode "
        f"({model_s * 1e3:.1f} ms/batch; the first batch of a size, which "
        f"captures the AR step's CUDA graph, {first_s * 1e3:.1f} ms); "
        f"median of 3; card {card}")

    # f32 on the card against f32 on the CPU (plain path), same seed weights;
    # the first batch runs AR step 0 eagerly and captures the step's CUDA
    # graph, the second replays the graph from step 0 on reset buffers
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec32 = TextRecognizer(device="cuda", dtype=torch.float32, from_pretrained=False)
    cpu32 = TextRecognizer(device="cpu", from_pretrained=False)
    for what, x in (("capture", crops[:16]), ("replay", crops[16:32])):
        x = torch.from_numpy(x)
        n0 = dict(ops.launches)
        got = rec32.model.forward_logits(x).cpu()
        check(all(ops.launches[k] > n0[k] for k in OCR_KERNELS),
              f"f32 run missed a kernel: {n0} -> {ops.launches}")
        want = cpu32.model.forward_logits(x)
        log(f"slice: f32 card vs CPU on 16 lines ({what}): {f32_card_vs_cpu_logits(got, want)}")
    return launches, dict(page=lines_page, quads=quads, crops=crops,
                          ids_bf16=ids_bf16)


# ------------------------------------------------------------------ phase 4


def _in_page(schema, w, h, what):
    for el in list(schema.paragraphs) + list(schema.figures):
        x1, y1, x2, y2 = el.box
        check(0 <= x1 <= x2 <= w and 0 <= y1 <= y2 <= h and math.isfinite(el.score),
              f"{what}: box {el.box} / score {el.score} off the page")


def _rtdetr_f32_vs_cpu(cfg, images, fused=False, page=None, what=None):
    """One RT-DETRv2 in f32 on the card and on the CPU, seed-0 weights on
    both: the same top-k selected queries outside near-ties (scores within
    1e-3 of the k-th's magnitude), then, over the queries both sides
    selected (at least 90% of k), logits within 1e-3 of the largest and
    boxes within 1e-3, matched by query index.  Each side's output rows
    map to queries by its model's own selection, the same ``torch.topk``
    call on the same scores on its device: two queries of bit-equal score
    may come in either order there (numpy's stable sort orders them by
    index, which parts from the top-k at such ties).  ``fused``: the card runs
    the fused backbone (its switch set by the caller) and the CPU the
    plain versions of its kernels, the gates forced open.  ``page``: a
    padded uint8 page, cropped on each device by the page route
    (``forward_from_page``) with ``images`` = (maps, out_hw).  ``what``:
    the printed line's prefix."""
    import numpy as np
    import torch

    from yomitoku_tpu_torch import ops
    from yomitoku_tpu_torch.models.rtdetr import RTDETRv2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    k = cfg.RTDETRTransformerv2.num_queries
    outs, scores, selected = [], [], []
    kernels = LAYOUT_KERNELS + (("fused_bottleneck",) if fused else ())
    for device in ("cuda", "cpu"):
        model = RTDETRv2(cfg, device=device, dtype=torch.float32)
        seen = {}
        hook = model.decoder.enc_score_head.register_forward_hook(
            lambda m, i, o: seen.__setitem__("s", o.float().amax(-1)))
        n0 = dict(ops.launches)
        undo = _force_fused_on_cpu() if fused and device == "cpu" else None
        try:
            if page is None:
                out = model(images)
            else:
                out = model.forward_from_page(torch.from_numpy(page).to(device), *images)
        finally:
            if undo:
                undo()
        hook.remove()
        if device == "cuda":
            torch.cuda.synchronize()
            check(all(ops.launches[k] > n0[k] for k in kernels),
                  f"f32 RT-DETR run missed a kernel: {n0} -> {ops.launches}")
        outs.append({name: v[0].cpu().numpy() for name, v in out.items()})
        scores.append(seen["s"][0].cpu().numpy())
        selected.append(torch.topk(seen["s"], k, dim=1).indices[0].cpu().numpy())
        del model
    (got, want), (s_g, s_c), (sel_g, sel_c) = outs, scores, selected
    order_c = np.argsort(-s_c, kind="stable")  # for the k-th and (k+1)-th scores
    kth = s_c[order_c[k - 1]]
    tie = 1e-3 * abs(kth)
    differ = set(sel_g) ^ set(sel_c)
    near = [i for i in differ if abs(s_c[i] - kth) <= tie]
    d_score = float(np.abs(s_g - s_c).max())
    check(len(near) == len(differ),
          f"f32 selected queries differ outside near-ties: {sorted(differ)}")
    row_g = {q: r for r, q in enumerate(sel_g)}
    row_c = {q: r for r, q in enumerate(sel_c)}
    common = sorted(set(row_g) & set(row_c))
    check(len(common) >= 0.9 * k,
          f"f32 card and CPU share only {len(common)} of {k} selected queries")
    rg, rc = [row_g[q] for q in common], [row_c[q] for q in common]
    d_logit = float(np.abs(got["pred_logits"][rg] - want["pred_logits"][rc]).max())
    d_box = float(np.abs(got["pred_boxes"][rg] - want["pred_boxes"][rc]).max())
    limit = 1e-3 * float(np.abs(want["pred_logits"]).max())
    at = (f"{images[1][0]}x{images[1][1]} from the page" if page is not None
          else f"{images.shape[1]}x{images.shape[2]}")
    what = what or ("fused" if fused else "page" if page is not None else "layout")
    log(f"{what}: f32 RT-DETRv2 "
        f"card vs CPU at {at}: "
        f"selection score max|d| {d_score:.3e}; k-th/(k+1)-th gap "
        f"{kth - s_c[order_c[k]]:.3e}; {len(differ)} selected queries differ"
        f"{' (all near-ties)' if differ else ''}; over the {len(common)} "
        f"shared: max|d logit| {d_logit:.3e} (limit {limit:.3e}), max|d box| "
        f"{d_box:.3e} (limit 1e-3)")
    check(d_logit <= limit and d_box <= 1e-3, "f32 RT-DETR card vs CPU disagree")


def phase_layout(card):
    with _env(YOMITOKU_TPU_HOST_CROPS="1"):
        return _phase_layout(card)


def _phase_layout(card):
    import cv2
    import numpy as np
    import torch

    from yomitoku_tpu_torch import ops
    from yomitoku_tpu_torch.layout_analyzer import LayoutAnalyzer

    t0 = time.perf_counter()
    la = LayoutAnalyzer(device="cuda")  # rtdetrv2v2 + rtdetrv2, seed-0 weights
    lp, tsr = la.layout_parser, la.table_structure_recognizer
    log(f"layout: LayoutAnalyzer(device='cuda') built in "
        f"{time.perf_counter() - t0:.1f} s: RT-DETRv2 {lp.model.param_count():,} "
        f"+ {tsr.model.param_count():,} params, {lp.model.dtype}, weights "
        f"{lp.model.pretrained_source or 'seed-0 random'}")
    page = cv2.imread(str(ROOT / "demo" / "sample_table.png"))
    check(page is not None, "demo/sample_table.png missing")
    h, w = page.shape[:2]

    # the main path, counted: the analyzer on the page, then the table
    # recognizer batched over the fixed boxes
    ops.reset_launches()
    result, _ = la(page)
    tables, _ = tsr(page, TABLE_BOXES)
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    log(f"layout: launches {launches}")
    check(all(launches[k] > 0 for k in LAYOUT_KERNELS),
          f"a kernel of the layout path was never launched: {launches}")
    check_attention_routes("layout", "wgmma_small")
    check_gemm_routes("layout", runs_gemm=False)
    check_deform_routes("layout", launches["ms_deformable_attention"])
    _in_page(result, w, h, "layout")
    data = tsr.preprocess(page, TABLE_BOXES)
    preds = tsr.model(np.stack([d["array"] for d in data]))
    n_q = tsr._cfg.RTDETRTransformerv2.num_queries
    check(tuple(preds["pred_logits"].shape) == (len(TABLE_BOXES), n_q, 3)
          and tuple(preds["pred_boxes"].shape) == (len(TABLE_BOXES), n_q, 4),
          "table recognizer output shape")
    boxes = preds["pred_boxes"]
    check(bool(torch.isfinite(preds["pred_logits"]).all())
          and bool(((boxes >= 0) & (boxes <= 1)).all()),
          "table recognizer logits not finite or boxes off [0, 1]")
    log(f"layout: on sample_table.png {w}x{h}: {len(result.paragraphs)} "
        f"paragraphs, {len(result.figures)} figures, {len(result.tables)} "
        f"tables; the recognizer on {len(TABLE_BOXES)} fixed boxes: "
        f"{len(tables)} tables with rows and columns, "
        f"{sum(len(t.cells) for t in tables)} cells")
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "layout_sample.json").write_text(result.model_dump_json(indent=1))

    # throughput (reported, not gated)
    times = {
        "layout_parser": host_timed(lambda: lp(page)),
        "tsr_4_tables": host_timed(lambda: tsr(page, TABLE_BOXES)),
        "layout_analyzer": host_timed(lambda: la(page)),
    }
    log("layout: " + ", ".join(f"{k} {v * 1e3:.1f} ms/page" for k, v in times.items())
        + f" on sample_table.png, bf16, median of 3; card {card}")
    profile = {}
    for what, fn in (("layout_parser", lambda: lp(page)),
                     ("tsr_4_tables", lambda: tsr(page, TABLE_BOXES))):
        wall, device, n, _ = profiled(fn, runs=5)
        busy = sum(device.values())
        top = sorted(device.items(), key=lambda kv: -kv[1])[:6]
        profile[what] = dict(wall_ms=wall, device_busy_ms=busy,
                             idle_share=1 - busy / wall,
                             device_ops_per_call=n, top_kernels=top)
        log(f"layout: {what} profiled: {wall:.1f} ms/call wall, device busy "
            f"{busy:.1f} ms (idle share {1 - busy / wall:.2f}), {n:.0f} device "
            "ops per call; top: " + "; ".join(f"{k[:60]} {v:.2f} ms" for k, v in top))
    (OUT / "layout_profile.json").write_text(json.dumps(profile, indent=1))
    cfg = lp._cfg
    del la, lp, tsr, preds, boxes
    torch.cuda.empty_cache()
    _rtdetr_f32_vs_cpu(cfg, np.ascontiguousarray(
        cv2.resize(cv2.cvtColor(page, cv2.COLOR_BGR2RGB), (640, 640),
                   interpolation=cv2.INTER_AREA))[None])
    return launches


# ------------------------------------------------------------------ phase 5


def _int8_cases(rng, L=L, D=D):
    """name -> (numpy args as (value, kind), trailing args): kind "x" is the
    activation (the dtype under test), "w" a float weight to quantize, "v"
    a float32 vector; ``L`` tokens per line of width ``D``."""
    ws = D ** -0.5
    nrm = lambda shape, std=1.0: (rng.standard_normal(shape) * std).astype("float32")  # noqa: E731
    vec = lambda n, c=0.0, std=0.02: (c + rng.standard_normal(n) * std).astype("float32")  # noqa: E731
    block = [(nrm((B, L, D)), "x"), (vec(D, 1.0, 0.1), "v"), (vec(D), "v")]
    for _ in range(4):
        block += [(nrm((D, D), ws), "w"), (vec(D), "v")]
    mlp = [(nrm((B * L, D)), "x"), (vec(D, 1.0, 0.1), "v"), (vec(D), "v"),
           (nrm((D, HIDDEN), ws), "w"), (vec(HIDDEN), "v"),
           (nrm((HIDDEN, D), HIDDEN ** -0.5), "w"), (vec(D), "v")]
    return {"fused_attention_block_ln_int8": (block, (HEADS,)),
            "fused_mlp_ln_int8": (mlp, ())}


def _int8_args(case, dtype):
    """The case on the card: x in ``dtype``, each weight as its int8 codes
    (the transpose of a row-major (out, in) tensor) and f32 scales."""
    import torch

    from yomitoku_tpu_torch import ops

    out = []
    for a, kind in case:
        t = torch.from_numpy(a).cuda()
        if kind == "x":
            out.append(t.to(dtype))
        elif kind == "w":
            out += list(ops.quantize_weight_int8(t))
        else:
            out.append(t)
    return out


def _held_int8(got, want):
    """f32: within 1e-4 of the largest value plus 1e-5 on all rows but those
    where a code moved by one step at a rounding tie (at most 1%), which
    stay within 2e-2 -> (max|d|, share of rows past 1e-4, ok, text)."""
    d = (got.float() - want).abs().reshape(-1, want.shape[-1]).amax(-1)
    top = want.abs().max().item()
    share = (d > 1e-4 * top + 1e-5).float().mean().item()
    err = d.max().item()
    ok = share <= 1e-2 and err <= 2e-2 * top and math.isfinite(err)
    return err, share, ok, (f"max|d| {err:.3e}, rows past 1e-4 of max "
                            f"{share:.2e} (limit 1e-2; max limit {2e-2 * top:.3e})")


def _held_int8_block(f32, tail, got):
    """The int8 attention block in f32 at a full batch, where the row-quantize
    kernel's codes of LayerNorm(x) differ from the plain quantizer's in about
    one code in a million (one step, at a tie the two f32 LayerNorms round
    to either side of), and each such code moves every row of its line:
    the codes at most one step off and at most 1e-4 of them moved, the
    1%-of-rows rule (``_held_int8``) on the lines no moved code reaches,
    and on every row against the plain version on the kernel's own codes
    -> (max|d| against the plain version, its share of rows past 1e-4,
    ok, text)."""
    import torch

    from yomitoku_tpu_torch import ops
    from yomitoku_tpu_torch.ops._common import layer_norm, quantize_rows
    from yomitoku_tpu_torch.ops.mlp import quantize_rows_reference

    x, g, b = f32[:3]
    B, Lx, Dx = x.shape
    ref = ops.fused_attention_block_ln_int8_reference
    xq = torch.empty((B * Lx, Dx), dtype=torch.int8, device=x.device)
    sx = torch.empty((B * Lx, 1), dtype=torch.float32, device=x.device)
    quantize_rows(x.view(B * Lx, Dx), xq, sx, ln=(g, b, 1e-6))
    hq, _ = quantize_rows_reference(layer_norm(x, g, b, 1e-6, torch.float32).view(B * Lx, Dx))
    step = (xq.int() - hq.int()).abs()
    moved = (step > 0).float().mean().item()
    flipped = (step > 0).view(B, Lx * Dx).any(1)
    want = ref(*f32, *tail)
    top = want.abs().max().item()
    d = (got.float() - want).abs().reshape(B, Lx, Dx).amax(-1)
    share = (d > 1e-4 * top + 1e-5).float().mean().item()
    clean = (d[~flipped] > 1e-4 * top + 1e-5).float().mean().item()
    err = d.max().item()
    err_same, share_same, ok_same, _ = _held_int8(got, ref(*f32, *tail, ln_codes=(xq, sx)))
    ok = (step.max().item() <= 1 and moved <= 1e-4 and clean <= 1e-2 and ok_same
          and err <= 2e-2 * top and math.isfinite(err))
    return err, share, ok, (
        f"LayerNorm codes moved {moved:.2e} (limit 1e-4, max step {step.max().item()}) in "
        f"{int(flipped.sum())}/{B} lines; max|d| {err:.3e} (limit {2e-2 * top:.3e}), rows "
        f"past 1e-4 of max {share:.2e}, on the lines no moved code reaches {clean:.2e} "
        f"(limit 1e-2); on the kernel's codes max|d| {err_same:.3e}, rows past 1e-4 "
        f"{share_same:.2e} (limit 1e-2)")


def _stock_int8(name, args, tail):
    """The stock composition: F.layer_norm, row quantize (torch ops),
    torch._int_mm (cuBLASLt int8), dequantize; for the attention block
    SDPA between (on the bf16 projections, its output quantized in f32)."""
    import torch
    import torch.nn.functional as F

    from yomitoku_tpu_torch import ops

    def mm(a, w, s_row, s_col, bias):
        return torch._int_mm(a, w).float() * s_row * s_col + bias

    if name == "fused_mlp_ln_int8":
        x, g, b, w1, s1, b1, w2, s2, b2 = args
        xq, sx = ops.quantize_rows_reference(F.layer_norm(x.float(), (D,), g, b, 1e-6))
        chunk = ops.hidden_chunk(w1.shape[1])
        gq, sg = ops.quantize_rows_reference(F.gelu(mm(xq, w1, sx, s1, b1)), chunk)
        acc = 0
        for c in range(sg.shape[1]):
            sl = slice(c * chunk, (c + 1) * chunk)
            acc = acc + torch._int_mm(gq[:, sl].contiguous(), w2[sl]).float() * sg[:, c:c + 1] * s2
        return (x.float() + acc + b2).to(x.dtype)
    x, g, b, wq, sq, bq, wk, sk, bk, wv, sv, bv, wo, so, bo = args
    (h,) = tail
    Bx, Lx, Dx = x.shape
    hq, sh = ops.quantize_rows_reference(
        F.layer_norm(x.float(), (Dx,), g, b, 1e-6).reshape(-1, Dx))
    q, k, v = (mm(hq, w, sh, s, bias).to(x.dtype).view(Bx, Lx, h, Dx // h).transpose(1, 2)
               for w, s, bias in ((wq, sq, bq), (wk, sk, bk), (wv, sv, bv)))
    attn = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(-1, Dx)
    aq, sa = ops.quantize_rows_reference(attn.float())
    return (x.float() + mm(aq, wo, sa, so, bo).view(Bx, Lx, Dx)).to(x.dtype)


def _ms(v):
    return "not measured" if v is None else f"{v:.4f} ms"


def phase_int8_kernels(seed=2, L=L, D=D, names=None, codes_rule=False):
    """The int8 kernels (those in ``names``, all where None) at the
    recognizer's shapes, or at ``L`` tokens of width ``D`` -> {kernel:
    numbers}.  ``codes_rule``: the attention block's f32 held by
    ``_held_int8_block`` (LayerNorm code ties moving whole lines), as phase
    8 holds it."""
    import numpy as np
    import torch

    from yomitoku_tpu_torch import ops

    results = {}
    for name, (case, tail) in _int8_cases(np.random.default_rng(seed), L, D).items():
        if names is not None and name not in names:
            continue
        kern = getattr(ops, name)
        ref = getattr(ops, name + "_reference")
        with torch.no_grad():
            f32 = _int8_args(case, torch.float32)
            if codes_rule and name == "fused_attention_block_ln_int8":
                err32, share32, ok32, text32 = _held_int8_block(f32, tail, kern(*f32, *tail))
            else:
                err32, share32, ok32, text32 = _held_int8(kern(*f32, *tail), ref(*f32, *tail))
            del f32
            bf = _int8_args(case, torch.bfloat16)
            out16 = kern(*bf, *tail)
            want = ref(*[a.float() if a.dtype == torch.bfloat16 else a for a in bf], *tail)
            err16, ok16, text16 = _held(out16, want, None, 2e-2, 0.0, 0.0)
            stock_err = (_stock_int8(name, bf, tail).float() - want).abs().max().item()
            del want
            route = route_taken(lambda: kern(*bf, *tail))
        torch.cuda.synchronize()
        log(f"kernel {name} {tuple(bf[0].shape)}: f32 {text32} {'ok' if ok32 else 'FAIL'}; "
            f"bf16 {text16} {'ok' if ok16 else 'FAIL'}; stock composition vs plain "
            f"(bf16) max|d| {stock_err:.3e}; attention route {route}")
        check(ok32 and ok16, f"{name} at {tuple(bf[0].shape)} disagrees with its plain version")
        check(route in (None, "wgmma", "wgmma_small"),
              f"{name} at {tuple(bf[0].shape)} in bf16 took the attention route {route}")
        bound_ms, bound_by = bound(bf, [out16], kernel_ops(name, bf, tail))
        del out16
        with torch.no_grad():
            res = dict(
                max_abs_err=err16, max_abs_err_f32=err32,
                f32_rows_past_1e4=share32, stock_max_abs_err=stock_err,
                attention_route=route, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                ms=median_ms(lambda: kern(*bf, *tail)),
                plain_ms=median_ms(lambda: ref(*bf, *tail), runs=3),
                stock_ms=median_ms(lambda: _stock_int8(name, bf, tail)),
                device_ms=device_ms(lambda: kern(*bf, *tail)),
                stock_device_ms=device_ms(lambda: _stock_int8(name, bf, tail)),
            )
        log(f"kernel {name}: bf16 {res['ms']:.3f} ms per call (device "
            f"{_ms(res['device_ms'])}), plain {res['plain_ms']:.3f} ms, stock "
            f"composition {res['stock_ms']:.3f} ms (device "
            f"{_ms(res['stock_device_ms'])}); bound {bound_ms:.4f} ms "
            f"({bound_by}); median of 10")
        results[name] = res
        del bf
        torch.cuda.empty_cache()
    ops.reset_launches()
    return results


def _int8_gemm_inputs(gen, M, K, nc, N, epilogue, out_dtype):
    """Codes and scales on the card, made there from ``gen``: a (M, K), w
    (K, N) as the transpose of (N, K) rows, sa (M, nc), sw, bias, res."""
    import torch

    dt = getattr(torch, out_dtype)
    a = torch.randint(-127, 128, (M, K), dtype=torch.int8, device="cuda", generator=gen)
    w = torch.randint(-127, 128, (N, K), dtype=torch.int8, device="cuda", generator=gen).t()
    sa = torch.rand((M, nc), device="cuda", generator=gen) * 1e-3
    sw = torch.rand(N, device="cuda", generator=gen) * 1e-3
    bias = torch.randn(N, device="cuda", generator=gen)
    res = (torch.randn((M, N), device="cuda", generator=gen).to(dt)
           if "res" in epilogue else None)
    return a, w, sa, sw, bias, res, torch.empty((M, N), dtype=dt, device="cuda")


def _int8_gemm_plain(a, w, sa, sw, bias, res, gelu):
    """The plain version on the same codes: exact int32 sums per K-chunk
    (int_matmul), dequantize in the Pallas order, + bias, GELU, + res."""
    import torch.nn.functional as F

    from yomitoku_tpu_torch.ops.mlp import dequantize, int_matmul

    nc, kc = sa.shape[1], a.shape[1] // sa.shape[1]
    want = 0
    for c in range(nc):
        sl = slice(c * kc, (c + 1) * kc)
        want = want + dequantize(int_matmul(a[:, sl], w[sl]), sa[:, c:c + 1], sw)
    want = want + bias
    if gelu:
        want = F.gelu(want)
    return want if res is None else res.float() + want


def gemm_int8_route_of(fn):
    """The int8 GEMM route(s) that one call of ``fn`` launched."""
    import torch

    from yomitoku_tpu_torch.ops._common import gemm_int8_route_launches

    before = dict(gemm_int8_route_launches)
    fn()
    torch.cuda.synchronize()
    return "+".join(r for r, n in gemm_int8_route_launches.items() if n > before[r]) or None


def phase_gemm_int8():
    """The int8 GEMM kernel alone at every int8 GEMM shape of the W8A8
    sublayers, with the epilogue the sublayer runs: the route, max|d|
    against the plain version on the same codes and scales (f32 output
    within 1e-5 of the largest value, bf16 within 2^-8 of it), device ms
    (profiler, the kernel alone), TOP/s, the bound, one torch._int_mm at
    the same (M, K, N) (cuBLASLt, int32 output, no epilogue) as the
    yardstick (never called by the port), and each route that takes the
    shape on the same inputs; then the row-quantize kernel at its three
    shapes (codes against the plain version's: at most one step apart, on
    at most 1e-3 of them) -> ({label: numbers}, {label: numbers})."""
    import torch

    from yomitoku_tpu_torch import ops
    from yomitoku_tpu_torch.ops._common import gemm_int8, launch_gemm_int8, quantize_rows

    gen = torch.Generator(device="cuda").manual_seed(5)
    gemms = {}
    for label, (M, K, nc, N, epilogue, out_dtype) in INT8_GEMM_SHAPES.items():
        gelu = "gelu" in epilogue
        a, w, sa, sw, bias, res, out = _int8_gemm_inputs(gen, M, K, nc, N, epilogue, out_dtype)
        call = lambda: gemm_int8(a, sa, w, sw, bias, out, res=res, gelu=gelu)  # noqa: E731
        route = gemm_int8_route_of(call)
        want = _int8_gemm_plain(a, w, sa, sw, bias, res, gelu)
        err = (out.float() - want).abs().max().item()
        limit = (1e-5 if out_dtype == "float32" else 2 ** -8) * want.abs().max().item()
        del want
        check(math.isfinite(err) and err <= limit,
              f"gemm_int8 [{label}]: max|d| {err:.3e} over {limit:.3e}")
        check(route in GEMM_INT8_ROUTES, f"gemm_int8 [{label}] took route {route}")
        ops_n = 2 * M * K * N
        r = dict(route=route, max_abs_err=err, limit=limit,
                 device_ms=device_ms(call, "gemm_int8"),
                 int_mm_device_ms=device_ms(lambda: torch._int_mm(a, w)))
        r["tops"] = ops_n / r["device_ms"] / 1e9 if r["device_ms"] else None
        r["bound_ms"], r["bound_by"] = bound(
            [t for t in (a, w, sa, sw, bias, res) if t is not None], [out], {"int8": ops_n})
        for other in GEMM_INT8_ROUTES:  # the route taken is timed above
            if other == route or (other == "wgmma" and nc > 1):  # "wgmma" holds no fold
                continue
            r[f"{other}_device_ms"] = device_ms(
                lambda: launch_gemm_int8(other, a, sa, w, sw, bias, out, res, gelu), "gemm_int8")
        r[f"{route}_device_ms"] = r["device_ms"]
        tops = "not measured" if r["tops"] is None else f"{r['tops']:.1f}"
        log(f"gemm_int8 [{label}] M {M} K {K} ({nc} chunk{'s' if nc > 1 else ''}) N {N} "
            f"{'+'.join(epilogue)} -> {out_dtype}: route {route}, max|d| {err:.3e} (limit "
            f"{limit:.3e}); device {_ms(r['device_ms'])}, {tops} TOP/s ({ops_n / 1e9:.1f} "
            f"GOP) against one torch._int_mm's {_ms(r['int_mm_device_ms'])}; bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
        log(f"gemm_int8 routes [{label}]: " + ", ".join(
            f"{x} {_ms(r[x + '_device_ms'])}" for x in GEMM_INT8_ROUTES if x + "_device_ms" in r))
        gemms[label] = r
        del a, w, sa, sw, bias, res, out
        torch.cuda.empty_cache()

    quants = {}
    for label, (M, K, nc, dtype, ln) in QUANTIZE_SHAPES.items():
        x = (torch.randn((M, K), device="cuda", generator=gen) * 3).to(getattr(torch, dtype))
        g = 1 + 0.1 * torch.randn(K, device="cuda", generator=gen)
        b = 0.1 * torch.randn(K, device="cuda", generator=gen)
        q = torch.empty((M, K), dtype=torch.int8, device="cuda")
        sc = torch.empty((M, nc), device="cuda")
        call = lambda: quantize_rows(x, q, sc, ln=(g, b, 1e-6) if ln else None)  # noqa: E731
        call()
        v = ops.layer_norm(x, g, b, 1e-6, torch.float32) if ln else x.float()
        wq, ws = ops.quantize_rows_reference(v, K // nc)
        d = (q.int() - wq.int()).abs()
        moved, worst = d.float().mean().item(), d.max().item()
        s_err = ((sc - ws).abs() / ws).max().item()
        del v, wq, ws, d
        check(worst <= 1 and moved <= 1e-3 and s_err <= 1e-6,
              f"quantize_rows [{label}]: codes {worst} apart on {moved:.2e} of them, "
              f"scales {s_err:.2e} apart")
        r = dict(max_code_step=worst, codes_moved=moved, max_scale_rel_err=s_err,
                 device_ms=device_ms(call, "quantize_rows"))
        r["bound_ms"], r["bound_by"] = bound([x] + ([g, b] if ln else []), [q, sc], {})
        log(f"quantize_rows [{label}] M {M} K {K} ({nc} chunk{'s' if nc > 1 else ''}) "
            f"{dtype}{' + LayerNorm' if ln else ''}: codes {worst} step(s) apart on "
            f"{moved:.2e} of them, scales within {s_err:.1e}; device "
            f"{_ms(r['device_ms'])}; bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        quants[label] = r
        del x, q, sc
        torch.cuda.empty_cache()
    ops.reset_launches()
    return gemms, quants


def check_gemm_int8_routes(what, launches):
    """After the int8 path's counted run: the int8 GEMM kernel's launches by
    route, two for each launch of an int8 sublayer (its two products), every
    one on a TMA + wgmma route."""
    from yomitoku_tpu_torch.ops._common import gemm_int8_route_launches

    routes = dict(gemm_int8_route_launches)
    log(f"{what}: gemm_int8 launches by route {routes}")
    want = 2 * (launches["fused_attention_block_ln_int8"] + launches["fused_mlp_ln_int8"])
    check(set(routes) == set(GEMM_INT8_ROUTES) and sum(routes.values()) == want > 0,
          f"{what}: the int8 GEMM launches by route are off: {routes} (expected {want})")


# ------------------------------------------------------------------ phase 6


def _force_int8_on_cpu():
    """The port's int8 encoder gates opened for CPU tensors (its plain
    versions), as tests/test_torch_int8.py opens them -> undo callable."""
    from yomitoku_tpu_torch.models.layers import attention

    saved = {n: getattr(attention, n) for n in
             ("use_int8_encoder", "_use_fused_block", "_use_fused_mlp")}
    attention.use_int8_encoder = lambda x: True
    attention._use_fused_block = lambda x, h: True
    attention._use_fused_mlp = lambda x: True
    return lambda: [setattr(attention, n, f) for n, f in saved.items()]


def phase_int8_recognizer(card, ctx):
    with _env(YOMITOKU_TPU_INT8_ENCODER="1", YOMITOKU_TPU_INT8_KV=None,
              YOMITOKU_TPU_HOST_CROPS="1"):
        return _phase_int8_recognizer(card, ctx)


def _phase_int8_recognizer(card, ctx):
    import numpy as np
    import torch

    from yomitoku_tpu_torch import ops
    from yomitoku_tpu_torch.data.dataset import ParseqDataset
    from yomitoku_tpu_torch.text_recognizer import TextRecognizer

    rec = TextRecognizer(device="cuda")  # parseq-large-v4_1, seed-0 weights
    model = rec.model
    check(model.int8_kv, "the int8 memory-K/V cache is not on by default on CUDA")
    page, quads, crops = ctx["page"], ctx["quads"], ctx["crops"]

    # the main path, counted: the recognizer on the synthetic page (a batch
    # of 128 and one of 8)
    ops.reset_launches()
    lines, _ = rec(page, quads)
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    log(f"int8: launches {launches}")
    check(all(launches[k] > 0 for k in INT8_KERNELS),
          f"a kernel of the int8 recognizer path was never launched: {launches}")
    check_attention_routes("int8", "wgmma")
    check_gemm_routes("int8")
    check_gemm_int8_routes("int8", launches)
    check(launches["fused_attention_block_ln"] == 0 and launches["fused_mlp_ln"] == 0,
          f"the int8 path ran a bf16 encoder kernel: {launches}")
    _finite_schema(lines, "int8 recognizer")
    check(len(lines.contents) == len(quads), "int8 recognizer lost lines")
    ops.reset_launches()
    ids8, probs8 = model.forward_tokens(crops)
    per_batch = {k: ops.launches[k] for k in INT8_KERNELS}
    log(f"int8: launches for one batch of 128: {per_batch}")
    check(per_batch["fused_attention_block_ln_int8"] == 12
          and per_batch["fused_mlp_ln_int8"] == 12,
          f"expected 12 launches of each int8 kernel per batch: {per_batch}")
    check(np.isfinite(probs8).all(), "int8 probs not finite")
    loop = model._ar_loops[(128, L)]
    check(loop.graph is not None and loop.mem[0].dtype == torch.int8,
          "the batch-128 AR loop is not one CUDA graph over an int8 memory cache")
    same = float((ids8 == ctx["ids_bf16"]).mean())
    log(f"int8: greedy ids equal to the bf16 path's (full K/V cache) at "
        f"{same:.4f} of {ids8.size} positions (seed-0 random weights)")

    rec_s = host_timed(lambda: rec(page, quads[:128]))
    crop_s = host_timed(lambda: ParseqDataset(rec._cfg, page, quads[:128]).as_u8_array())
    model_s = host_timed(lambda: model.forward_tokens(crops))
    busy, attn, _, int8_ms = decode_profile(model, crops)
    log(f"int8: decode on the device (profiler): busy {busy:.2f} ms per batch of "
        f"128, of which the attention kernel {attn:.3f} ms and the int8 GEMM with "
        f"its row-quantize passes {int8_ms:.3f} ms ({int8_ms / busy:.3f} of busy)")
    log(f"int8: recognizer batch 128 (int8 encoder + int8 K/V): {128 / rec_s:.1f} "
        f"lines/s end to end ({rec_s * 1e3:.1f} ms, of which host crops "
        f"{crop_s * 1e3:.1f} ms), {128 / model_s:.1f} lines/s device decode "
        f"({model_s * 1e3:.1f} ms/batch); median of 3; card {card}")
    audit = model.audit_int8_kv()
    log(f"int8: audit of the int8 memory-K/V cache (4 random crops): "
        f"{'kept' if audit else 'diverged, turned off'}")
    del rec, model, loop
    torch.cuda.empty_cache()

    # f32 int8 on the card against the plain int8 path on the CPU, same
    # seed weights, 8 lines, in two hops.  The encoder (the int8 kernels):
    # memory within 5e-2 of its largest value, the JAX package's int8
    # tolerance (tests/test_int8_encoder.py), since a code that moves by one
    # step at a rounding tie (f32 sums in another order) spreads through
    # attention to every row of its line and compounds over 12 blocks; a
    # wiring fault gives errors of the order of the values.  The decoder with the
    # int8 memory-K/V cache, both sides on the CPU's memory: greedy ids
    # equal, except that a line may part from the CPU's at a near-tie
    # (top-2 gap < 1e-3) and is compared only up to there.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec32 = TextRecognizer(device="cuda", dtype=torch.float32, from_pretrained=False)
    cpu32 = TextRecognizer(device="cpu", from_pretrained=False)
    cpu32.model.int8_kv = True
    x = torch.from_numpy(crops[:8])
    n0 = dict(ops.launches)
    with torch.no_grad():
        mem_card = rec32.model.encode(x).cpu()
        check(all(ops.launches[k] > n0[k] for k in INT8_KERNELS[:2]),
              f"f32 int8 run missed a kernel: {n0} -> {ops.launches}")
        # the control: the CPU against itself with its input moved by one
        # part in 1e6, which shows how far such code moves spread
        xf = x.float() * (1.0 / 127.5) - 1.0
        jitter = 1.0 + 1e-6 * torch.randn(xf.shape, generator=torch.Generator().manual_seed(0))
        undo = _force_int8_on_cpu()
        try:
            mem_cpu = cpu32.model.encode(x)
            mem_ctl = cpu32.model.encode(xf * jitter)
        finally:
            undo()
        d = (mem_card - mem_cpu).abs()
        err_m, top_m = d.max().item(), mem_cpu.abs().max().item()
        mean_m = (d.mean() / mem_cpu.abs().mean()).item()
        dc = (mem_ctl - mem_cpu).abs()
        log(f"int8: f32 encoder memory card vs CPU on 8 lines: max|d| {err_m:.3e} "
            f"(limit {5e-2 * top_m:.3e}, 5e-2 of max), mean|d| / mean|ref| "
            f"{mean_m:.3e}; the CPU against itself with its input moved by 1e-6: "
            f"max|d| {dc.max().item():.3e}, mean|d| / mean|ref| "
            f"{(dc.mean() / mem_cpu.abs().mean()).item():.3e}")
        check(err_m <= 5e-2 * top_m, "f32 int8 encoder memory differs from the CPU's")
        got = rec32.model.logits_from_memory(mem_cpu.cuda()).cpu()
        want = cpu32.model.logits_from_memory(mem_cpu)
    check(torch.isfinite(got).all().item(), "f32 int8 card logits not finite")
    top2 = want.topk(2, dim=-1).values
    tie = (top2[..., 0] - top2[..., 1]) < 1e-3
    differ = got.argmax(-1) != want.argmax(-1)
    parted = 0
    for r in range(differ.shape[0]):
        cols = torch.nonzero(differ[r])[:, 0]
        if len(cols):
            check(bool(tie[r, cols[0]]), f"f32 int8 line {r} parts from the CPU's "
                  f"at position {int(cols[0])}, which is not a near-tie")
            parted += 1
    log(f"int8: f32 decoder (int8 K/V) card vs CPU on the same memory, 8 lines: "
        f"ids equal at {int((~differ).sum())}/{differ.numel()} positions; "
        f"{parted} lines part at a near-tie (top-2 gap < 1e-3); max|d logit| "
        f"{(got - want).abs().max().item():.3e}")
    return launches, dict(ids_equal_bf16=same, audit_kept=audit,
                          decode_busy_ms=busy, decode_int8_gemm_ms=int8_ms,
                          f32_memory_max_abs_err=err_m,
                          f32_memory_mean_rel_err=mean_m,
                          f32_lines_parted_at_near_tie=parted,
                          lines_s_end_to_end=128 / rec_s,
                          lines_s_device_decode=128 / model_s,
                          ms_per_batch=model_s * 1e3)


# ------------------------------------------------------------------ phase 7


def _force_fused_on_cpu():
    """The port's fused-backbone gates opened for CPU tensors (the plain
    versions of the kernels; stride 1 still required), as
    tests/test_torch_fused_backbone.py opens them -> undo callable."""
    from yomitoku_tpu_torch.models.layers import resnet

    saved = {n: getattr(resnet, n) for n in
             ("use_fused_bottleneck", "use_fused_stage", "fused_backbone")}
    resnet.use_fused_bottleneck = lambda x, stride, *a: stride == 1
    resnet.use_fused_stage = lambda x, n, *a: n >= 2
    resnet.fused_backbone = lambda x: True
    return lambda: [setattr(resnet, n, f) for n, f in saved.items()]


def _seeded_blocks(specs, seed):
    """The port's unfused ``Bottleneck`` modules, f32 on the card, seeded:
    lecun-normal convolutions, FrozenBN statistics drawn around their
    identity.  specs: [(Cin, Cm, dilation, projection)]."""
    import torch

    from yomitoku_tpu_torch.models.base import init_standard_layers
    from yomitoku_tpu_torch.models.layers.resnet import Bottleneck, FrozenBatchNorm

    gen = torch.Generator().manual_seed(seed)
    blocks = torch.nn.Sequential(*[Bottleneck(cin, cm, 1, d, proj)
                                   for cin, cm, d, proj in specs])
    init_standard_layers(blocks, gen)
    with torch.no_grad():
        for m in blocks.modules():
            if isinstance(m, FrozenBatchNorm):
                n = m.weight.numel()
                m.weight.copy_(1 + 0.1 * torch.randn(n, generator=gen))
                m.bias.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(n, generator=gen))
    return blocks.cuda()


def _fused_cases():
    """(kernel, label) -> (blocks, x shape (B, H, W, C), dilation): the
    block modules whose folded weights the kernel reads."""
    cases = {}
    for i, (label, (H, W, cin, cm, cout, d, proj)) in enumerate(BOTTLENECK_SHAPES.items()):
        cases[("fused_bottleneck", label)] = (
            _seeded_blocks([(cin, cm, d, proj)], 100 + i), (1, H, W, cin), d)
    for i, (label, (H, W, c, cm, n, d)) in enumerate(STAGE_SHAPES.items()):
        cases[("fused_identity_stage", label)] = (
            _seeded_blocks([(c, cm, d, False)] * n, 200 + i), (1, H, W, c), d)
    return cases


def _fused_args(name, blocks, x, dtype):
    """The kernel's arguments: x (NHWC) and the blocks' folded weights."""
    from yomitoku_tpu_torch.models.layers.resnet import stage_weights

    if name == "fused_bottleneck":
        return [x.to(dtype)] + list(blocks[0].folded(dtype))
    return [x.to(dtype)] + list(stage_weights(list(blocks), dtype))


def _timings(kern, plain, stock, library=None):
    """Per-call times (CUDA events, median of 10) and device times
    (profiler, every kernel of the call) of the kernel, its plain version
    and the stock op, and of one library call where there is one."""
    return dict(ms=median_ms(kern), plain_ms=median_ms(plain, runs=3),
                stock_ms=median_ms(stock), device_ms=device_ms(kern),
                stock_device_ms=device_ms(stock),
                library_ms=None if library is None else median_ms(library),
                library_device_ms=None if library is None else device_ms(library))


def _log_timings(name, label, res):
    log(f"kernel {name} [{label}]: bf16 {res['ms']:.4f} ms per call (device "
        f"{_ms(res['device_ms'])}), plain {res['plain_ms']:.4f} ms, stock "
        f"{res['stock_ms']:.4f} ms (device {_ms(res['stock_device_ms'])}), "
        f"library {'none' if res['library_ms'] is None else _ms(res['library_ms'])} "
        f"(device {_ms(res['library_device_ms'])}); "
        f"bound {res['bound_ms']:.4f} ms "
        f"({res['bound_by']})")


def phase_fused_kernels(convs=True, attention=True):
    """Kernels 10 and 11 at the main paths' shapes, with each of their
    convolutions (``convs``), and kernels 6 and 7 (``attention``) ->
    {kernel: {label: numbers}}.  The stock op of the bottleneck kernels is
    the unfused modules (cuDNN) in channels_last bf16; its f32 run is also
    held to the plain version, an independent check of the BN folding."""
    import copy

    import numpy as np
    import torch

    from yomitoku_tpu_torch import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    rng = np.random.default_rng(7)
    for (name, label), (blocks, shape, d) in _fused_cases().items():
        kern = getattr(ops, name)
        ref = (ops.bottleneck_reference if name == "fused_bottleneck"
               else ops.fused_identity_stage_reference)
        x = torch.from_numpy(rng.standard_normal(shape).astype("float32")).cuda()
        with torch.no_grad():
            a32 = _fused_args(name, blocks, x, torch.float32)
            want32 = ref(*a32, dilation=d)
            err32, ok32, text32 = _held(kern(*a32, dilation=d), want32, None,
                                        1e-4, 1e-5, 0.0)
            # the unfused modules take NCHW: x.permute is channels_last
            stock32 = blocks(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            err_s, oks, texts = _held(stock32, want32, None, 1e-4, 1e-5, 0.0)
            del a32, want32, stock32
            a16 = _fused_args(name, blocks, x, torch.bfloat16)
            out16 = kern(*a16, dilation=d)
            err16, ok16, text16 = _held(out16, ref(*a16, dilation=d).float(),
                                        None, 2e-2, 0.0, 0.0)
        torch.cuda.synchronize()
        log(f"kernel {name} [{label}] x {tuple(shape)} d={d}: f32 {text32} "
            f"{'ok' if ok32 else 'FAIL'}; bf16 {text16} {'ok' if ok16 else 'FAIL'}; "
            f"unfused cuDNN f32 vs plain {texts} {'ok' if oks else 'FAIL'}")
        check(ok32 and ok16 and oks, f"{name} [{label}] disagrees with its plain version")
        blocks16 = copy.deepcopy(blocks).to(torch.bfloat16)
        xs16 = a16[0].permute(0, 3, 1, 2)
        with torch.no_grad():
            res = _timings(lambda: kern(*a16, dilation=d),
                           lambda: ref(*a16, dilation=d), lambda: blocks16(xs16))
        res.update(max_abs_err=err16, max_abs_err_f32=err32,
                   stock_f32_max_abs_err=err_s)
        res["bound_ms"], res["bound_by"] = bound(a16, [out16], kernel_ops(name, a16, ()))
        _log_timings(name, label, res)
        if convs:
            with torch.no_grad():
                res["convs"] = conv_numbers(name, label, a16, d)
        results.setdefault(name, {})[label] = res
        del blocks, blocks16, a16, out16, x, xs16
        torch.cuda.empty_cache()
    if attention:
        results.update(_attention_kernels(rng))
    ops.reset_launches()
    return results


#: the kernels of csrc/bottleneck.cu as the profiler names them
BOTTLENECK_DEVICE_NAMES = r"\bconv_(?:wgmma|combine|bf16|f32)_kernel"


def _conv_cases(name, a16, d):
    """The three convolutions of the kernel's (first) block on the card, in
    bf16, as it runs them: {conv: launch_conv's keyword arguments}, each
    input the plain version's output of the convolution before."""
    from yomitoku_tpu_torch import ops

    x, w1, b1, w2, b2, w3, b3 = a16[:7]
    wd, bd = (a16[7], a16[8]) if name == "fused_bottleneck" and a16[7] is not None else (None, None)
    if name == "fused_identity_stage":
        w1, b1, w2, b2, w3, b3 = (t[0] for t in (w1, b1, w2, b2, w3, b3))
    h1 = ops.conv_reference(x, w1, b1)
    h2 = ops.conv_reference(h1, w2, b2, dilation=d)
    expand = (dict(x2=x, w2=wd, bias2=bd) if wd is not None else dict(res=x))
    return {"reduce": dict(x=x, w=w1, bias=b1), "conv3x3": dict(x=h1, w=w2, bias=b2, dilation=d),
            "expand": dict(x=h2, w=w3, bias=b3, **expand)}


def conv_numbers(name, label, a16, d):
    """Each convolution of the kernel at this shape, launched alone
    (uncounted) on the route its plan picks: max|d| against the plain
    version on the same bf16 values (2e-2 of the largest value), device ms
    (the kernel and, on the split route, its combine pass), TFLOP/s, the
    bound, the padding share of its units, and one F.conv2d call with the
    folded weight and bias (bf16, channels_last, no relu) as cuDNN's
    yardstick; then every route that takes the shape on the same inputs ->
    {conv: numbers}."""
    import torch
    import torch.nn.functional as F

    from yomitoku_tpu_torch import ops
    from yomitoku_tpu_torch.ops._common import (
        _MIN_SPLIT_STEPS, _sm_count, conv_k_steps, conv_padding, conv_plan, conv_splits,
        launch_conv)

    sms = _sm_count(torch.cuda.current_device())
    out = {}
    for conv, kw in _conv_cases(name, a16, d).items():
        x, w = kw["x"], kw["w"]
        B, H, W, K = x.shape
        N, taps = w.shape[-1], 9 if w.dim() == 3 else 1
        K2 = 0 if kw.get("x2") is None else kw["x2"].shape[-1]
        M, steps = B * H * W, conv_k_steps(K, taps, K2)
        route, bw, bh, splits = conv_plan(torch.bfloat16, B, H, W, K, N, taps, K2, True, sms)
        want = ops.conv_reference(**kw)
        limit = 2e-2 * want.float().abs().max().item()
        got = torch.empty_like(want)

        def run(r, sp, got=got, kw=kw):
            return lambda: launch_conv(r, out=got, splits=sp, **kw)

        routes = {"wgmma": 1, "wgmma_small": 1}
        split = conv_splits(M, N, steps, sms)
        if split > 1 or steps >= 2 * _MIN_SPLIT_STEPS:
            routes["wgmma_split"] = max(2, split)
        times = {}
        for r, sp in routes.items():
            got.zero_()
            run(r, sp)()
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            check(math.isfinite(err) and err <= limit,
                  f"conv [{label}/{conv}] on {r}: max|d| {err:.3e} over {limit:.3e}")
            times[f"{r}({sp})" if r == "wgmma_split" else r] = (
                _device_ms_retried(run(r, sp), "conv_"), err)
        key = f"{route}({splits})" if route == "wgmma_split" else route
        dev, err = times[key]
        flops = 2 * M * N * (taps * K + K2)
        reads = [kw[k] for k in ("x", "w", "bias", "x2", "w2", "bias2", "res") if kw.get(k) is not None]
        bms, by = bound(reads, [got], {"bf16": flops})
        xc = x.permute(0, 3, 1, 2)  # channels_last NCHW
        wc = w.t()[:, :, None, None] if taps == 1 else w.reshape(3, 3, K, N).permute(3, 2, 0, 1)
        wc = wc.contiguous(memory_format=torch.channels_last)
        pad = d if taps == 9 else 0
        bc = kw["bias"].to(torch.bfloat16)
        cudnn = _device_ms_retried(lambda: F.conv2d(xc, wc, bc, padding=pad, dilation=pad or 1))
        r = dict(route=route, splits=splits, patch=(bw, bh), M=M, K=K, K2=K2, N=N, taps=taps,
                 padding=conv_padding(route, taps, B, H, W), max_abs_err=err, limit=limit,
                 device_ms=dev, tflops=flops / dev / 1e9 if dev else None, bound_ms=bms,
                 bound_by=by, conv2d_device_ms=cudnn,
                 routes={k: v[0] for k, v in times.items()})
        tf = "not measured" if r["tflops"] is None else f"{r['tflops']:.1f}"
        log(f"conv [{label}/{conv}] M {M} K {K}{f' + {K2}' if K2 else ''} N {N} "
            f"{'3x3 d=' + str(d) if taps == 9 else '1x1'}: route {key} (patch {bw}x{bh}, "
            f"padding {100 * r['padding']:.1f}%), max|d| {err:.3e} (limit {limit:.3e}); device "
            f"{_ms(dev)}, {tf} TFLOP/s against one F.conv2d's {_ms(cudnn)}; bound {bms:.4f} ms "
            f"({by})")
        log(f"conv routes [{label}/{conv}]: " + ", ".join(
            f"{k} {_ms(v[0])}" for k, v in times.items()))
        out[conv] = r
        del want, got
    return out


def _device_ms_retried(fn, kernel="", tries=3):
    """``device_ms``, taken again (at most ``tries`` times) where a profiler
    window lost the kernel's records."""
    for _ in range(tries):
        ms = device_ms(fn, kernel)
        if ms is not None:
            return ms
    return None


def bottleneck_share(device):
    """Device ms per call of csrc/bottleneck.cu's kernels in a profiler
    window's {kernel: ms}."""
    import re

    return sum(v for k, v in device.items() if re.search(BOTTLENECK_DEVICE_NAMES, k))


def _attention_kernels(rng, shape=ATTENTION_SHAPE, block_shape=ATTENTION_BLOCK_SHAPE,
                       labels=("vit", "aifi")):
    """``fused_attention`` at ``shape`` (B, H, L, Dh), the ViT's, and
    ``fused_attention_block`` at ``block_shape`` (B, L, D), 8 heads, the
    AIFI's; under ``labels`` -> {kernel: {label: numbers}}.  In bf16 each
    must take a wgmma route."""
    import torch
    import torch.nn.functional as F

    from yomitoku_tpu_torch import ops

    def dev(shape, std=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * std).astype("float32")).cuda()

    B, L, D = block_shape
    block = [dev((B, L, D))]
    for _ in range(4):
        block += [dev((D, D), D ** -0.5), dev((D,), 0.05)]

    def stock_block(x, wq, bq, wk, bk, wv, bv, wo, bo):
        split = lambda t: t.view(B, L, HEADS, D // HEADS).transpose(1, 2)  # noqa: E731
        a = F.scaled_dot_product_attention(split(x @ wq + bq), split(x @ wk + bk),
                                           split(x @ wv + bv))
        return a.transpose(1, 2).reshape(B, L, D) @ wo + bo

    def library_block(args):
        """One F.multi_head_attention_forward call, its weights in torch's
        (out, in) layout."""
        x, wq, bq, wk, bk, wv, bv, wo, bo = args
        w_in = torch.cat([wq.t(), wk.t(), wv.t()]).contiguous()
        b_in, w_out, xt = torch.cat([bq, bk, bv]), wo.t().contiguous(), x.transpose(0, 1)
        return lambda: F.multi_head_attention_forward(
            xt, xt, xt, D, HEADS, w_in, b_in, None, None, False, 0.0, w_out, bo,
            training=False, need_weights=False)

    cases = {
        ("fused_attention", labels[0]): (
            ops.fused_attention_reference, F.scaled_dot_product_attention,
            [dev(shape) for _ in range(3)], ()),
        ("fused_attention_block", labels[1]): (
            ops.fused_attention_block_reference, stock_block, block, (HEADS,)),
    }
    results = {}
    for (name, label), (ref, stock, f32, tail) in cases.items():
        kern = getattr(ops, name)
        bf = [a.to(torch.bfloat16) for a in f32]
        with torch.no_grad():
            err32, ok32, text32 = _held(kern(*f32, *tail), ref(*f32, *tail), None,
                                        1e-4, 1e-5, 0.0)
            out16 = kern(*bf, *tail)
            err16, ok16, text16 = _held(out16, ref(*[a.float() for a in bf], *tail),
                                        None, 2e-2, 0.0, 0.0)
            route = route_taken(lambda: kern(*bf, *tail))
        torch.cuda.synchronize()
        log(f"kernel {name} [{label}] {tuple(bf[0].shape)}: f32 {text32} "
            f"{'ok' if ok32 else 'FAIL'}; bf16 {text16} {'ok' if ok16 else 'FAIL'}; "
            f"attention route {route}")
        check(ok32 and ok16, f"{name} [{label}] disagrees with its plain version")
        check(route in ("wgmma", "wgmma_small"),
              f"{name} [{label}] in bf16 took the attention route {route}")
        library = ((lambda: F.scaled_dot_product_attention(*bf))
                   if name == "fused_attention" else library_block(bf))
        with torch.no_grad():
            res = _timings(lambda: kern(*bf, *tail), lambda: ref(*bf, *tail),
                           lambda: stock(*bf), library)
        res.update(max_abs_err=err16, max_abs_err_f32=err32, attention_route=route)
        res["bound_ms"], res["bound_by"] = bound(bf, [out16], kernel_ops(name, bf, tail))
        _log_timings(name, label, res)
        if name == "fused_attention":
            with torch.no_grad():
                res.update(attention_numbers(lambda: kern(*bf), library,
                                             kernel_ops(name, bf, ())["bf16"]))
                if shape[-1] % 8 == 0:  # the (B*H, L, Dh) views, one head each
                    res.update(consumer_warpgroups(name, label, *(
                        a.reshape(-1, *a.shape[2:]) for a in bf), 1))
            log_attention(name, label, res)
        results[name] = {label: res}
        del f32, bf, out16
        torch.cuda.empty_cache()
    return results


def check_conv_routes(what, routes):
    """After a fused bf16 path's counted run: the convolution kernel's
    launches by route; none on "fma" (the f32 kernel), some on the wgmma
    routes."""
    log(f"{what}: conv launches by route {routes}")
    check(routes["fma"] == 0 and sum(routes.values()) > 0,
          f"{what}: a bf16 convolution left the wgmma routes: {routes}")


def _both_backbones(fn, runs=3):
    """Median host times (s) of ``fn`` ending in a sync, with the fused
    backbone and with the default one, taken in turns (default, fused,
    fused, default) after one warm-up call each -> (fused, default)."""
    times = {True: [], False: []}
    for fused in (False, True, True, False):
        with _env(YOMITOKU_TPU_FUSED_BOTTLENECK="1" if fused else None,
                  YOMITOKU_TPU_FUSED_STAGE="1" if fused else None):
            fn()
            times[fused].append(host_timed(fn, runs))
    return statistics.median(times[True]), statistics.median(times[False])


def phase_fused_backbone(card):
    """The fused-backbone path -> (launches, numbers)."""
    with _env(YOMITOKU_TPU_FUSED_BOTTLENECK="1", YOMITOKU_TPU_FUSED_STAGE="1",
              YOMITOKU_TPU_INT8_KV="0", YOMITOKU_TPU_INT8_ENCODER=None,
              YOMITOKU_TPU_HOST_CROPS="1"):
        return _phase_fused_backbone(card)


def _phase_fused_backbone(card):
    import cv2
    import numpy as np
    import torch

    from yomitoku_tpu_torch import ops
    from yomitoku_tpu_torch.layout_analyzer import LayoutAnalyzer
    from yomitoku_tpu_torch.ocr import OCR
    from yomitoku_tpu_torch.ops._common import conv_route_launches
    from yomitoku_tpu_torch.text_detector import TextDetector

    ocr = OCR(device="cuda")  # dbnetv2_1 + parseq-large-v4_1, seed-0 weights
    la = LayoutAnalyzer(device="cuda")  # rtdetrv2v2 + rtdetrv2, seed-0 weights
    lp, tsr = la.layout_parser, la.table_structure_recognizer
    sample = cv2.imread(str(ROOT / "demo" / "sample_text.png"))
    page = cv2.imread(str(ROOT / "demo" / "sample_table.png"))
    check(sample is not None and page is not None, "demo pages missing")

    # the main path, counted: OCR on the text page, then layout analysis
    # and the table recognizer on the fixed boxes of the table page
    ops.reset_launches()
    result, _ = ocr(sample)
    torch.cuda.synchronize()
    on_ocr = dict(ops.launches)
    conv_on_ocr = dict(conv_route_launches)
    layout, _ = la(page)
    tables, _ = tsr(page, TABLE_BOXES)
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    check_attention_routes("fused")
    check_gemm_routes("fused")
    check_deform_routes("fused", launches["ms_deformable_attention"])
    check_conv_routes("fused: OCR", conv_on_ocr)
    check_conv_routes("fused: layout", {r: n - conv_on_ocr[r]
                                        for r, n in conv_route_launches.items()})
    on_layout = {k: launches[k] - on_ocr[k] for k in launches}
    log(f"fused: launches on OCR {on_ocr}")
    log(f"fused: launches on layout {on_layout}")
    check(on_ocr["fused_bottleneck"] == 2 and on_ocr["fused_identity_stage"] == 4,
          f"OCR with the fused backbone: expected 2 fused_bottleneck and 4 "
          f"fused_identity_stage launches per page: {on_ocr}")
    rtdetr_calls = on_layout["ms_deformable_attention"] // 6
    check(on_layout["fused_bottleneck"] == 13 * rtdetr_calls > 0
          and on_layout["fused_identity_stage"] == 0,
          f"layout with the fused backbone: expected 13 fused_bottleneck "
          f"launches per RT-DETR call ({rtdetr_calls} calls): {on_layout}")
    check(len(result.words) > 0, "fused OCR schema holds no words")
    _in_page(layout, page.shape[1], page.shape[0], "fused layout")
    log(f"fused: OCR on sample_text.png: {len(result.words)} words; layout: "
        f"{len(layout.paragraphs)} paragraphs, {len(tables)} tables on the "
        "fixed boxes")

    # times against the default backbone in the same run
    det = ocr.detector.model
    u8 = torch.from_numpy(ocr.detector.preprocess_u8(sample))
    xl = lp.preprocess(page)
    numbers = {}
    for what, fn in (("detector", lambda: ocr.detector(sample)),
                     ("ocr", lambda: ocr(sample)),
                     ("layout_parser", lambda: lp(page)),
                     ("tsr_4_tables", lambda: tsr(page, TABLE_BOXES))):
        fused_s, default_s = _both_backbones(fn)
        numbers[what] = dict(fused_ms=fused_s * 1e3, default_ms=default_s * 1e3)
        log(f"fused: {what} {fused_s * 1e3:.1f} ms/page fused, "
            f"{default_s * 1e3:.1f} ms default (median, in turns)")
    for what, fn in (("dbnet_forward", lambda: det.forward_u8(u8)),
                     ("rtdetr_forward", lambda: lp.model(xl))):
        busy = {}
        for fused in (True, False):
            with _env(YOMITOKU_TPU_FUSED_BOTTLENECK="1" if fused else None,
                      YOMITOKU_TPU_FUSED_STAGE="1" if fused else None):
                wall, device, n, _ = profiled(fn, runs=5)
            busy["fused" if fused else "default"] = dict(
                wall_ms=wall, device_busy_ms=sum(device.values()),
                device_ops_per_call=n, bottleneck_kernels_ms=bottleneck_share(device),
                top_kernels=sorted(device.items(), key=lambda kv: -kv[1])[:5])
        numbers[what] = busy
        f = busy["fused"]
        log(f"fused: {what} csrc/bottleneck.cu kernels {f['bottleneck_kernels_ms']:.3f} ms of "
            f"{f['device_busy_ms']:.3f} ms device busy "
            f"({100 * f['bottleneck_kernels_ms'] / f['device_busy_ms']:.1f}%)")
        log(f"fused: {what} on the device (profiler): fused "
            f"{busy['fused']['device_busy_ms']:.3f} ms busy of "
            f"{busy['fused']['wall_ms']:.2f} ms, default "
            f"{busy['default']['device_busy_ms']:.3f} ms of "
            f"{busy['default']['wall_ms']:.2f} ms; fused top: "
            + "; ".join(f"{k[:50]} {v:.3f}" for k, v in busy["fused"]["top_kernels"]))
    log(f"fused: card {card}")

    # bf16 probability map, fused against unfused (the JAX package's
    # in-model bound, tests/test_stage_kernel.py)
    x = det.standardize_u8(u8)
    fused_map = det(x)
    with _env(YOMITOKU_TPU_FUSED_BOTTLENECK=None, YOMITOKU_TPU_FUSED_STAGE=None):
        base_map = det(x)
    d = (fused_map - base_map).abs()
    numbers["bf16_map_max_abs_diff"] = d.max().item()
    numbers["bf16_map_mean_abs_diff"] = d.mean().item()
    log(f"fused: bf16 DBNet map at {u8.shape[1]}x{u8.shape[2]}, fused vs unfused: "
        f"max|d| {d.max().item():.3e} (limit 3e-2), mean {d.mean().item():.3e} "
        "(limit 2e-3)")
    check(d.max().item() <= 3e-2 and d.mean().item() <= 2e-3,
          "bf16 DBNet map, fused vs unfused, out of bound")
    cfg = lp._cfg
    del ocr, la, lp, tsr, det, fused_map, base_map, x
    torch.cuda.empty_cache()

    # f32 on the card against the CPU, gates forced open there
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu32 = TextDetector(device="cuda", dtype=torch.float32, from_pretrained=False).model
    cpu32 = TextDetector(device="cpu", from_pretrained=False).model
    xs = cpu32.standardize_u8(u8)
    n0 = dict(ops.launches)
    got = gpu32(xs.cuda()).cpu()
    check(ops.launches["fused_bottleneck"] - n0["fused_bottleneck"] == 2
          and ops.launches["fused_identity_stage"] - n0["fused_identity_stage"] == 4,
          f"f32 fused DBNet missed a kernel: {n0} -> {ops.launches}")
    undo = _force_fused_on_cpu()
    try:
        t0 = time.perf_counter()
        want = cpu32(xs)
        cpu_s = time.perf_counter() - t0
    finally:
        undo()
    err = (got - want).abs().max().item()
    numbers["f32_map_max_abs_diff"] = err
    log(f"fused: f32 DBNet map card vs CPU at {xs.shape[1]}x{xs.shape[2]}: "
        f"max|d| {err:.3e} (limit 1e-4); the CPU took {cpu_s:.1f} s")
    check(err <= 1e-4 and bool(torch.isfinite(got).all()),
          "f32 fused DBNet card vs CPU disagree")
    del gpu32, cpu32
    _rtdetr_f32_vs_cpu(cfg, np.ascontiguousarray(
        cv2.resize(cv2.cvtColor(page, cv2.COLOR_BGR2RGB), (640, 640),
                   interpolation=cv2.INTER_AREA))[None], fused=True)
    return launches, numbers


# ------------------------------------------------------------------ main


# ------------------------------------------------------------------ phase 8


#: a fifth table box: the table recognizer also runs a batch of 5
TABLE_BOX_5 = [120, 200, 840, 1000]
#: the forced recognizer width bucket (half the 800-wide canvas)
WIDTH_BUCKET = 400


def _refuse_host_crops(*args, **kwargs):
    raise SmokeFailure("the device route built a ParseqDataset (host crops)")


@contextlib.contextmanager
def _no_host_crops():
    """ParseqDataset raises for the block: the device route never builds it."""
    from yomitoku_tpu_torch import text_recognizer

    orig = text_recognizer.ParseqDataset
    text_recognizer.ParseqDataset = _refuse_host_crops
    try:
        yield
    finally:
        text_recognizer.ParseqDataset = orig


def eager_decode(model, fn):
    """``fn()`` with every AR step run eagerly (no CUDA graph), on fresh
    loop state; the model's loops and their graphs are restored after."""
    from yomitoku_tpu_torch.models import parseq

    saved = dict(model._ar_loops)
    model._ar_loops.clear()
    capture = parseq._CachedARLoop._capture
    parseq._CachedARLoop._capture = parseq._CachedARLoop.step  # step 0, not captured
    try:
        return fn()
    finally:
        parseq._CachedARLoop._capture = capture
        model._ar_loops.clear()
        model._ar_loops.update(saved)


def _crop_err(got, want):
    d = (got.float().cpu() - want).abs()
    return d.max().item(), d.mean().item()


def region_flop(page_hw, out_hw, n):
    """float64 operations of sample_regions_separable on ``n`` regions
    (multiply-adds as two, three channels, the cheaper order it takes)."""
    (H, W), (oh, ow) = page_hw, out_hw
    return 2 * 3 * n * min(H * W * ow + H * ow * oh, H * W * oh + oh * W * ow)


def phase_page(card, ctx):
    """The device-page route, the CUDA default -> (launches by path,
    numbers)."""
    with _env(YOMITOKU_TPU_INT8_KV="0", YOMITOKU_TPU_INT8_ENCODER=None,
              YOMITOKU_TPU_HOST_CROPS=None, YOMITOKU_TPU_DEVICE_CROPS=None,
              YOMITOKU_TPU_REC_WIDTH_BUCKETS=None):
        return _phase_page(card, ctx)


def _phase_page(card, ctx):
    import cv2
    import numpy as np
    import torch

    from yomitoku_tpu_torch import ops
    from yomitoku_tpu_torch.data.dataset import ParseqDataset
    from yomitoku_tpu_torch.data.functions import shortest_edge_size
    from yomitoku_tpu_torch.layout_analyzer import LayoutAnalyzer
    from yomitoku_tpu_torch.ocr import OCR
    from yomitoku_tpu_torch.ops import device_crop as dc
    from yomitoku_tpu_torch.ops import separable_resize as sr
    from yomitoku_tpu_torch.text_detector import TextDetector
    from yomitoku_tpu_torch.text_recognizer import TextRecognizer

    numbers = {}
    sample = cv2.imread(str(ROOT / "demo" / "sample_text.png"))
    table = cv2.imread(str(ROOT / "demo" / "sample_table.png"))
    lines_page, quads = ctx["page"], ctx["quads"]
    cpu, cuda = torch.device("cpu"), torch.device("cuda")

    # gate 1: the crop functions on the card against the CPU
    extra = [[[20, 60], [400, 80], [398, 110], [18, 90]],       # skewed
             [[500, 300], [850, 270], [853, 306], [503, 336]],  # skewed
             [[100, 500], [700, 520], [690, 580], [95, 555]],   # perspective
             [[860, 40], [890, 40], [890, 400], [860, 400]],    # vertical
             [[10, 100], [500, 100], [500, 160], [10, 160]],    # shrunk to 32 rows
             [[5, 200], [895, 200], [895, 230], [5, 230]]]      # shrunk to 800 columns
    padded = dc.pad_page(lines_page)
    mats_all, wh_all = dc.line_homographies(quads + extra, (32, 800))
    regions = {
        "det_page": (sample, [(0, 0, sample.shape[1], sample.shape[0])],
                     shortest_edge_size(*sample.shape[:2], 1280, 1600), False),
        "layout_page": (table, [(0, 0, table.shape[1], table.shape[0])], (640, 640), True),
        "tsr_boxes": (table, [tuple(b) for b in TABLE_BOXES + [TABLE_BOX_5]], (640, 640), True),
    }
    t = {dev: torch.from_numpy(padded).to(dev) for dev in (cpu, cuda)}
    crops = {}
    for dev in (cpu, cuda):
        m, w = torch.from_numpy(mats_all), torch.from_numpy(wh_all)
        crops[dev] = {"sample_lines": dc.sample_lines(t[dev], m, w)}
        for label, (img, rs, hw, flip) in regions.items():
            mats_r, _ = dc.region_mats(rs, hw)
            crops[dev][label] = sr.sample_regions_separable(
                torch.from_numpy(dc.pad_page(img)).to(dev), torch.from_numpy(mats_r), hw,
                flip_bgr=flip)
    torch.cuda.synchronize()
    for label in crops[cpu]:
        err, mean = _crop_err(crops[cuda][label], crops[cpu][label])
        log(f"page: crop {label} card vs CPU {tuple(crops[cpu][label].shape)}: max|d| "
            f"{err:.3e} (limit 0.1), mean|d| {mean:.3e} (limit 1e-3), 0-255 scale")
        check(err <= 0.1 and mean <= 1e-3, f"crop {label}: card and CPU disagree")
        numbers[f"crop_{label}_max_abs_err"] = err
    del crops

    # the main path, counted: OCR on the sample page and the recognizer on
    # the synthetic page (a batch of 128 + a bucket-8 remainder), then the
    # layout analyzer and the table recognizer (4 and 5 tables), all on the
    # default route; ParseqDataset raises throughout
    ocr = OCR(device="cuda")
    la = LayoutAnalyzer(device="cuda")
    rec, lp, tsr = ocr.recognizer, la.layout_parser, la.table_structure_recognizer
    check(rec._use_device_crops(), "device crops are not the CUDA default")
    paths = {}
    with _no_host_crops():
        ops.reset_launches()
        result, _ = ocr(sample)
        lines, _ = rec(lines_page, quads)
        torch.cuda.synchronize()
        paths["ocr_page"] = dict(ops.launches)
        log(f"page: OCR path launches {paths['ocr_page']}")
        check(all(paths["ocr_page"][k] > 0 for k in OCR_KERNELS),
              f"a kernel of the OCR page path was never launched: {paths['ocr_page']}")
        check_attention_routes("page: OCR", "wgmma")
        check_gemm_routes("page: OCR")
        check(len(result.words) > 0 and len(lines.contents) == len(quads),
              "OCR page route lost its words or lines")
        _finite_schema(lines, "page: recognizer")
        ops.reset_launches()
        page_t = dc.DevicePage(table, "cuda")
        layout, _ = la(table, page=page_t)
        tables4, _ = tsr(table, TABLE_BOXES, page=page_t)
        tables5, _ = tsr(table, TABLE_BOXES + [TABLE_BOX_5], page=page_t)
        torch.cuda.synchronize()
        paths["layout_page"] = dict(ops.launches)
        log(f"page: layout path launches {paths['layout_page']}")
        check(all(paths["layout_page"][k] > 0 for k in LAYOUT_KERNELS),
              f"a kernel of the layout page path was never launched: {paths['layout_page']}")
        check_attention_routes("page: layout")
        check_gemm_routes("page: layout", runs_gemm=False)
        check_deform_routes("page: layout", paths["layout_page"]["ms_deformable_attention"])
        _in_page(layout, table.shape[1], table.shape[0], "page: layout")
        log(f"page: OCR on sample_text.png {len(result.words)} words; recognizer "
            f"{len(lines.contents)} lines; layout {len(layout.paragraphs)} paragraphs, "
            f"{len(layout.tables)} tables; table recognizer on 4 / 5 boxes: "
            f"{len(tables4)} / {len(tables5)} tables with rows and columns")

        prof = {}
        for what, fn in (("layout_parser", lambda: lp(table, page=dc.DevicePage(table, "cuda"))),
                         ("tsr_4_tables", lambda: tsr(table, TABLE_BOXES, page=page_t)),
                         ("ocr", lambda: ocr(sample))):
            wall, device, _, _ = profiled(fn, runs=5)
            busy = sum(device.values())
            prof[what] = dict(wall_ms=wall, device_busy_ms=busy, idle_share=1 - busy / wall)
            log(f"page: {what} profiled: {wall:.1f} ms/call wall, device busy {busy:.1f} ms "
                f"(idle share {1 - busy / wall:.2f})")

    # numbers (not gated): each call on the device route (a fresh DevicePage
    # where the caller would make one) and on the host route, in turns
    def on_device(fn):
        def run():
            with _no_host_crops():
                return fn()
        return run

    def on_host(fn):
        def run():
            with _env(YOMITOKU_TPU_HOST_CROPS="1"):
                return fn()
        return run

    calls = {
        "ocr": (lambda: ocr(sample),) * 2,
        "recognizer_128": (lambda: rec(lines_page, quads[:128]),) * 2,
        "layout_analyzer": (lambda: la(table, page=dc.DevicePage(table, "cuda")),
                            lambda: la(table)),
        "layout_parser": (lambda: lp(table, page=dc.DevicePage(table, "cuda")),
                          lambda: lp(table)),
        "tsr_4_tables": (lambda: tsr(table, TABLE_BOXES, page=dc.DevicePage(table, "cuda")),
                         lambda: tsr(table, TABLE_BOXES)),
    }
    fns = {}
    for what, (dev_fn, host_fn) in calls.items():
        fns[(what, "device")], fns[(what, "host")] = on_device(dev_fn), on_host(host_fn)
    ms = {k: v * 1e3 for k, v in interleaved(fns).items()}
    page_ms, host_page_ms = ms[("ocr", "device")], ms[("ocr", "host")]
    rec_s, host_rec_s = ms[("recognizer_128", "device")] / 1e3, ms[("recognizer_128", "host")] / 1e3
    layout_ms, host_layout_ms = ms[("layout_analyzer", "device")], ms[("layout_analyzer", "host")]
    lp_ms, host_lp_ms = ms[("layout_parser", "device")], ms[("layout_parser", "host")]
    tsr_ms, host_tsr_ms = ms[("tsr_4_tables", "device")], ms[("tsr_4_tables", "host")]
    crop_host = host_timed(lambda: ParseqDataset(rec._cfg, lines_page, quads[:128])
                           .as_u8_array()) * 1e3
    m128, w128 = torch.from_numpy(mats_all[:128]), torch.from_numpy(wh_all[:128])
    pt = t[cuda]
    crop_gather = median_ms(lambda: dc.sample_lines(pt, m128, w128), runs=5)
    gather_dev = device_ms(lambda: dc.sample_lines(pt, m128, w128), runs=5)
    log(f"page: crops of 128 lines ({padded.shape[0]}x{padded.shape[1]} page): host "
        f"ParseqDataset {crop_host:.1f} ms; device gather {crop_gather:.2f} ms (device "
        f"{_ms(gather_dev)}); card {card}")
    resize = {}
    for label, (img, rs, hw, flip) in regions.items():
        pg = torch.from_numpy(dc.pad_page(img)).to(cuda)
        mr = torch.from_numpy(dc.region_mats(rs, hw)[0])
        fn = (lambda pg=pg, mr=mr, hw=hw, flip=flip:
              sr.sample_regions_separable(pg, mr, hw, flip_bgr=flip))
        wall, dev_ms = median_ms(fn, runs=5), device_ms(fn, runs=5)
        flop = region_flop(pg.shape[:2], hw, len(rs))
        resize[label] = dict(ms=wall, device_ms=dev_ms, tflop=flop / 1e12)
        log(f"page: region resize {label} ({len(rs)} x {hw[0]}x{hw[1]} from "
            f"{pg.shape[0]}x{pg.shape[1]}): {wall:.2f} ms, device {_ms(dev_ms)}, "
            f"{flop / 1e12:.4f} TFLOP f64, "
            f"{'not measured' if not dev_ms else f'{flop / dev_ms / 1e9:.1f} TFLOP/s'}; "
            f"card {card}")
    log(f"page: recognizer batch 128 end to end: device route {128 / rec_s:.1f} lines/s "
        f"({rec_s * 1e3:.1f} ms), host route {128 / host_rec_s:.1f} lines/s "
        f"({host_rec_s * 1e3:.1f} ms); OCR {page_ms:.1f} ms/page device route, "
        f"{host_page_ms:.1f} ms/page host route; layout analyzer {layout_ms:.1f} / "
        f"{host_layout_ms:.1f} ms/page, layout parser {lp_ms:.1f} / {host_lp_ms:.1f} ms, "
        f"table recognizer on 4 tables {tsr_ms:.1f} / {host_tsr_ms:.1f} ms (device / host "
        f"route); median of 5, the two routes in turns; card {card}")
    numbers.update(
        crop_ms=dict(host_parseq_dataset=crop_host, device_gather=crop_gather,
                     device_gather_device=gather_dev),
        region_resize=resize,
        lines_s=dict(device_route=128 / rec_s, host_route=128 / host_rec_s),
        ocr_ms_per_page=dict(device_route=page_ms, host_route=host_page_ms),
        layout_ms=dict(analyzer=[layout_ms, host_layout_ms], parser=[lp_ms, host_lp_ms],
                       tsr_4_tables=[tsr_ms, host_tsr_ms]),
        profile=prof,
    )

    # gate 5: the 400-wide width bucket, forced
    model = rec.model
    with _no_host_crops():
        short_page, short_q = synthetic_lines_page(
            136, seed=1, chars=[(8, 21)] * 128 + [(30, 40)] * 8)
        mats_s, wh_s = dc.line_homographies(short_q, (32, 800))
        fits = wh_s[:, 0] <= WIDTH_BUCKET
        check(fits[:128].all() and not fits[128:].any(), "the bucket page's widths")
        page_s = dc.DevicePage(short_page, "cuda").dev
        full_c = dc.sample_lines(page_s, torch.from_numpy(mats_s[:128]),
                                 torch.from_numpy(wh_s[:128]))
        narrow_c = dc.sample_lines(page_s, torch.from_numpy(mats_s[:128]),
                                   torch.from_numpy(wh_s[:128]), out_hw=(32, WIDTH_BUCKET))
        same = torch.equal(narrow_c, full_c[:, :, :WIDTH_BUCKET])
        log(f"page: the {WIDTH_BUCKET}-wide crop of 128 lines equals the left slice of the "
            f"full crop bit for bit: {same}")
        check(same, "the narrow crop is not the left slice of the full crop")
        del full_c, narrow_c
        with _env(YOMITOKU_TPU_REC_WIDTH_BUCKETS=str(WIDTH_BUCKET)):
            check(rec._width_buckets() == [WIDTH_BUCKET], "the forced bucket")
            ops.reset_launches()
            routed = rec._call_device(short_page, short_q)
            torch.cuda.synchronize()
            paths["width_bucket"] = dict(ops.launches)
        ids_n, probs_n = model.forward_tokens_from_page(page_s, mats_s[:128], wh_s[:128],
                                                        out_w=WIDTH_BUCKET)
        want, want_s = rec.tokenizer.decode_ids(ids_n, probs_n)
        import unicodedata

        want = [unicodedata.normalize("NFKC", p) for p in want]
        check(routed[0][:128] == want and np.allclose(routed[1][:128], want_s, rtol=1e-6),
              "the routed narrow lines differ from the model run at width 400")
        log(f"page: {WIDTH_BUCKET}-wide bucket forced: 128 lines routed narrow and 8 full; "
            f"the narrow lines' strings equal the model's at out_w={WIDTH_BUCKET} called "
            f"directly; launches {paths['width_bucket']}")
        # each width captures its own graph, and a replay equals an eager decode
        m128s, w128s = mats_s[:128], wh_s[:128]
        dec = {w: (lambda w=w: model.forward_tokens_from_page(page_s, m128s, w128s, out_w=w))
               for w in (WIDTH_BUCKET, None)}
        model._ar_loops.clear()
        for w in (WIDTH_BUCKET, None):
            dec[w]()  # captures
        loops = {k: v for k, v in model._ar_loops.items() if k[0] == 128}
        check(set(loops) == {(128, L // 2), (128, L)}
              and all(v.graph is not None for v in loops.values())
              and loops[(128, L // 2)].graph is not loops[(128, L)].graph,
              f"batch 128 at 400 and 800 did not capture a graph each: {sorted(loops)}")
        for w in (WIDTH_BUCKET, None):
            replay = dec[w]()
            eager = eager_decode(model, dec[w])
            check(np.array_equal(replay[0], eager[0]),
                  f"width {w or 800}: the replayed graph's ids differ from an eager decode")
        log("page: batch 128 at 400 and 800 each captured its own AR graph; after a "
            "replay both give ids equal to an eager decode")
        s_narrow = host_timed(dec[WIDTH_BUCKET])
        s_full = host_timed(dec[None])
        log(f"page: decode of 128 lines from the page at width 400 {s_narrow * 1e3:.1f} ms, "
            f"at 800 {s_full * 1e3:.1f} ms ({s_full / s_narrow:.2f}x); card {card}")
        numbers["decode_ms"] = {"400": s_narrow * 1e3, "800": s_full * 1e3}
    lp_cfg = lp._cfg
    del ocr, la, rec, lp, tsr, model
    torch.cuda.empty_cache()

    # gate 5: kernels 1-4 and 8-9 at the narrow canvas against plain versions
    for name, (ref, _, case) in _kernel_cases(np.random.default_rng(8), L // 2).items():
        args = _on_card(case, torch.bfloat16, "out_in.t")
        fn, kargs = _kernel_call(name, args, "out_in.t")
        with torch.no_grad():
            got = fn(*kargs, *case["tail"])
            want = ref(*[a.float() for a in args], *case["tail"])
        x = args[0] if name.endswith("_ln") else None
        err, ok, text = _held(got, want, x, 2e-2, 0.0, 2.0 ** -8)
        log(f"page: kernel {name} at the {WIDTH_BUCKET}-wide bucket "
            f"{tuple(args[0].shape)} bf16: {text} {'ok' if ok else 'FAIL'}")
        check(ok, f"{name} at the narrow canvas disagrees with its plain version")
        numbers[f"narrow_{name}_max_abs_err"] = err
        del args, kargs, got, want
    for name, (case, tail) in _int8_cases(np.random.default_rng(9), L // 2).items():
        kern, ref = getattr(ops, name), getattr(ops, name + "_reference")
        with torch.no_grad():
            f32 = _int8_args(case, torch.float32)
            got32 = kern(*f32, *tail)
            if name == "fused_attention_block_ln_int8":
                err32, share, ok32, text32 = _held_int8_block(f32, tail, got32)
            else:
                err32, share, ok32, text32 = _held_int8(got32, ref(*f32, *tail))
            del f32, got32
            bf = _int8_args(case, torch.bfloat16)
            want = ref(*[a.float() if a.dtype == torch.bfloat16 else a for a in bf], *tail)
            err16, ok16, text16 = _held(kern(*bf, *tail), want, None, 2e-2, 0.0, 0.0)
            del bf, want
        log(f"page: kernel {name} at the {WIDTH_BUCKET}-wide bucket: f32 {text32}; "
            f"bf16 {text16} {'ok' if ok32 and ok16 else 'FAIL'}")
        check(ok32 and ok16, f"{name} at the narrow canvas disagrees with its plain version")
        numbers[f"narrow_{name}_max_abs_err"] = err16
        numbers[f"narrow_{name}_f32_rows_moved"] = share
    torch.cuda.empty_cache()

    # gate 4: f32 on the card against the CPU, on the page route
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec32 = TextRecognizer(device="cuda", dtype=torch.float32, from_pretrained=False)
    cpu32 = TextRecognizer(device="cpu", from_pretrained=False)
    # 10 printed lines and the six extra quads (skewed, perspective,
    # vertical, resampled)
    sel = list(range(10)) + list(range(len(quads), len(quads) + len(extra)))
    m16, w16 = mats_all[sel], wh_all[sel]
    ids_g, _ = rec32.model.forward_tokens_from_page(t[cuda], m16, w16)
    x = dc.sample_lines(t[cpu], torch.from_numpy(m16), torch.from_numpy(w16))
    want = cpu32.model.forward_logits(x * (1.0 / 127.5) - 1.0)
    top2 = want.topk(2, dim=-1).values
    tie = (top2[..., 0] - top2[..., 1]) < 1e-4
    differ = torch.from_numpy(ids_g).long() != want.argmax(-1)
    log(f"page: f32 recognizer card vs CPU from the page ({differ.shape[0]} lines): ids "
        f"equal at {int((~differ).sum())}/{differ.numel()}, {int(tie.sum())} near-tie "
        f"positions exempt")
    check(not (differ & ~tie).any().item(), "f32 page-route ids differ outside near-ties")
    del rec32, cpu32
    det_hw = shortest_edge_size(*sample.shape[:2], 1280, 1600)
    maps = []
    for dev in ("cuda", "cpu"):
        det = TextDetector(device=dev, dtype=torch.float32, from_pretrained=False)
        maps.append(det.model.forward_binary_from_page(
            torch.from_numpy(dc.pad_page(sample)).to(dev), sample.shape[:2], det_hw))
        del det
    dq = int(np.abs(maps[0].astype(int) - maps[1].astype(int)).max())
    log(f"page: f32 DBNet u8 map card vs CPU from the page at {det_hw}: max|d| {dq} "
        f"quantum (limit 1), {float((maps[0] != maps[1]).mean()):.2e} of pixels differ")
    check(dq <= 1, "f32 DBNet page-route maps differ by more than one quantum")
    mats_t, _ = dc.region_mats([(0, 0, table.shape[1], table.shape[0])], (640, 640))
    _rtdetr_f32_vs_cpu(lp_cfg, (mats_t, (640, 640)), page=dc.pad_page(table))
    return paths, numbers


# ------------------------------------------------------------------ phase 9


#: the kernels the DocumentAnalyzer path runs by default
DOCUMENT_KERNELS = OCR_KERNELS + ("ms_deformable_attention",)
#: max_in_flight of the batch path
IN_FLIGHT = 4


#: the share of the calibration queries each class keeps above its
#: threshold (thin_final_score_head): a few tables, figures and paragraphs
#: per page, and tables of about 9 rows and 9 columns
LAYOUT_KEEP, TSR_KEEP = 0.02, 0.03


def thin_final_score_head(module, call, keep):
    """Lower each class's bias of the score head the forward reads so that
    a share ``keep`` of its logits in ``call()`` (a call of the module, on
    the route the analyzer takes) clears the module's threshold: balanced
    heads pass about half of every class's queries, tens of tables of
    thousands of cells a page, where a page holds a few."""
    import torch

    model = module.model
    seen = []
    hook = model.decoder.register_forward_hook(
        lambda m, i, out: seen.append(out["pred_logits"].float().flatten(0, 1)))
    try:
        call()
    finally:
        hook.remove()
    check(seen, f"{type(module).__name__}: the call ran no forward to calibrate on")
    cut = torch.quantile(torch.cat(seen), 1 - keep, dim=0)
    head = model.decoder.dec_score_head[model.decoder.eval_idx]
    margin = math.log(module.thresh_score / (1 - module.thresh_score))
    with torch.no_grad():
        head.bias.sub_((cut - margin).to(head.bias.dtype))


def findable(da, table):
    """Spread and balance the layout parser's and the table recognizer's
    score heads (utils.synthetic_heads), calibrated on sample_table.png and
    on its fixed table boxes, then thin them on the page route's call on
    that page, so that seed-0 weights find a few tables with cells,
    paragraphs and figures on a page."""
    import numpy as np

    from yomitoku_tpu_torch.ops.device_crop import DevicePage
    from yomitoku_tpu_torch.utils.synthetic_heads import (
        balance_final_score_head,
        spread_score_heads,
    )

    lp, tsr = da.layout.layout_parser, da.layout.table_structure_recognizer
    balance_final_score_head(spread_score_heads(lp.model), lp.preprocess(table))
    crops = np.stack([d["array"] for d in tsr.preprocess(table, TABLE_BOXES)])
    balance_final_score_head(spread_score_heads(tsr.model), crops)
    page = DevicePage(table, lp.device)
    thin_final_score_head(lp, lambda: lp(table, page=page), LAYOUT_KEEP)
    thin_final_score_head(tsr, lambda: da.layout(table, page=page), TSR_KEEP)


def _ink_lines(bgr, out_hw):
    """A DBNet-like u8 map of a BGR page at ``out_hw``: its dark pixels
    joined along each line (11 px), closed across (3 px, less than the
    gap between two lines) and thinned to a core (3 px) that the
    postprocessor's unclip grows back to the line."""
    import cv2
    import numpy as np

    gray = cv2.cvtColor(np.ascontiguousarray(bgr), cv2.COLOR_BGR2GRAY)
    small = cv2.resize(gray, (out_hw[1], out_hw[0]), interpolation=cv2.INTER_AREA)
    rect = lambda w, h: cv2.getStructuringElement(cv2.MORPH_RECT, (w, h))  # noqa: E731
    lines = cv2.dilate((small < 128).astype(np.uint8), rect(11, 1))
    lines = cv2.morphologyEx(lines, cv2.MORPH_CLOSE, rect(1, 3))
    return (cv2.erode(lines, rect(1, 3)) * 230).astype(np.uint8)[None]


#: the host image of each DevicePage made since paint_detector first ran,
#: by (device, data pointer) of its padded page (the most recent 64)
_PAGE_IMAGES = {}
_PAGE_IMAGES_LOCK = threading.Lock()


def _remember_page_images():
    """Make every DevicePage remember its host image (_PAGE_IMAGES), so that
    a painted detector finds its page's ink without reading the page back
    from the card: on the fused route the detector's leg must not wait for
    the card before the wire's readback."""
    from yomitoku_tpu_torch.ops.device_crop import DevicePage, DevicePages

    if getattr(DevicePage, "_remembers_images", False):
        return
    init = DevicePage.__init__

    def remembering(self, img_bgr, device, align=512):
        init(self, img_bgr, device, align)
        _remember(self.dev, img_bgr)

    def remembering_stack(self, imgs_bgr, device, align=512):
        init_stack(self, imgs_bgr, device, align)
        for page, img in zip(self.dev, imgs_bgr):
            _remember(page, img)

    init_stack = DevicePages.__init__
    DevicePage.__init__ = remembering
    DevicePages.__init__ = remembering_stack
    DevicePage._remembers_images = True


def _remember(page, img):
    with _PAGE_IMAGES_LOCK:
        _PAGE_IMAGES[(page.device, page.data_ptr())] = img
        while len(_PAGE_IMAGES) > 64:
            _PAGE_IMAGES.pop(next(iter(_PAGE_IMAGES)))


def paint_detector(det):
    """After the detector's real forward, swap its map's contents for the
    page's ink joined into lines (_ink_lines), as the JAX package's
    bench.py paints its detector's map: seed-0 DBNet weights find one or
    two words on a page, too few lines for the recognizer's batch kernels
    (fused_mlp_ln takes 3 lines or more, fused_mlp 11).  The contours, the
    crops and everything after them run on the painted lines.  On the page
    routes (``forward_from_page``, which the unfused route reads back and
    the fused program ships in its wire; ``forward_from_pages``, the page
    axis's stack) the ink comes from the page's host image
    (_remember_page_images) and goes up from pinned memory without a
    wait."""
    import numpy as np
    import torch

    _remember_page_images()
    model = det.model
    from_page, from_u8 = model.forward_from_page, model.forward_binary_u8
    from_pages = model.forward_from_pages

    def ink(page, src_hw, out_hw):
        h, w = src_hw
        with _PAGE_IMAGES_LOCK:
            img = _PAGE_IMAGES.get((page.device, page.data_ptr()))
        if img is None:  # a page made before the first paint_detector
            img = page[:h, :w].cpu().numpy()
        return _ink_lines(img[:h, :w], out_hw)

    def up(lines, real):
        lines = torch.from_numpy(lines)
        if real.is_cuda:
            lines = lines.pin_memory()
        return lines.to(real.device, non_blocking=True)

    def painted_from_page(page, src_hw, out_hw):
        real = from_page(page, src_hw, out_hw)
        return up(ink(page, src_hw, real.shape[1:]), real)

    def painted_from_pages(pages, src_hws, out_hw):
        real = from_pages(pages, src_hws, out_hw)
        return up(np.concatenate([ink(p, hw, real.shape[1:]) for p, hw in zip(pages, src_hws)]),
                  real)

    def painted_u8(images_u8):
        real = from_u8(images_u8)
        return np.concatenate([_ink_lines(img, real.shape[1:]) for img in images_u8])

    model.forward_from_page = painted_from_page
    model.forward_from_pages = painted_from_pages
    model.forward_binary_u8 = painted_u8


@contextlib.contextmanager
def unpainted(det):
    """The detector's real page forwards for the block."""
    model = det.model
    painted = {name: model.__dict__.pop(name, None)
               for name in ("forward_from_page", "forward_from_pages")}
    try:
        yield
    finally:
        for name, fn in painted.items():
            if fn is not None:
                setattr(model, name, fn)


#: the two routes of phases 9-11: the fused page program (the CUDA
#: default) and the unfused route beside it
ROUTES = {"fused": None, "unfused": "1"}


def on_route(route, fn):
    """``fn`` with YOMITOKU_TPU_NO_FUSED_PAGE set for ``route``."""
    def run():
        with _env(YOMITOKU_TPU_NO_FUSED_PAGE=ROUTES[route]):
            return fn()
    return run


@contextlib.contextmanager
def slot_stats():
    """Per fused page, in call order: the tables the host kept, ``held``
    (those whose box a valid slot holds), ``hits`` (filled from their
    slot), ``saturated`` (held, but re-dispatched for a saturated capped
    top-k, with the warning counted from the log), ``fallback`` (on the
    chunked route) and ``dropped`` (valid slots whose box the host's filter
    did not keep: it drops tables inside tables, the device does not)."""
    import logging

    from yomitoku_tpu_torch.ops import fused_page

    pages, warnings = [], []
    real = fused_page.FusedPageAnalysis.consume_region_slots

    class Saturated(logging.Handler):
        def emit(self, record):
            if "saturated" in record.getMessage():
                warnings.append(record)

    def spy(self, region_data, packed_t, sel, valid, *args):
        warnings.clear()
        out = real(self, region_data, packed_t, sel, valid, *args)
        kept = {(d["offset"][0], d["offset"][1], d["offset"][0] + d["size"][1],
                 d["offset"][1] + d["size"][0]) for d in region_data}
        slots = {tuple(b) for b, v in zip(sel.tolist(), valid) if v}
        n, fallback = len(region_data), len(out[1])
        pages.append(dict(tables=n, held=len(kept & slots), hits=n - fallback,
                          fallback=fallback, dropped=len(slots - kept),
                          warnings=len(warnings)))
        pages[-1]["saturated"] = pages[-1]["held"] - pages[-1]["hits"]
        return out

    logger = logging.getLogger(fused_page.__name__)
    handler = Saturated()
    logger.addHandler(handler)
    fused_page.FusedPageAnalysis.consume_region_slots = spy
    try:
        yield pages
    finally:
        fused_page.FusedPageAnalysis.consume_region_slots = real
        logger.removeHandler(handler)


def check_slots(pages, what):
    """Every slot box the host kept was read from its slot or, with a
    warning, re-dispatched; the rest of the tables took the chunked route;
    and where the host kept every table the device selected, the slots
    held min(tables, 4) of them."""
    for i, p in enumerate(pages):
        check(p["hits"] + p["saturated"] == p["held"] and p["saturated"] == p["warnings"]
              and p["fallback"] == p["tables"] - p["hits"],
              f"{what}: fused page {i}: slots {p}")
        check(p["dropped"] or p["held"] == min(p["tables"], 4),
              f"{what}: fused page {i}: {p['held']} of {p['tables']} tables in the slots, "
              f"{min(p['tables'], 4)} expected: a slot's box is off the host's ({p})")


def log_slots(pages, names, what):
    log(f"{what}: fused slots per page (tables kept / slot hits / chunked route / "
        f"saturation warnings / slots the host's filter dropped): " + "; ".join(
            f"{n} {p['tables']}/{p['hits']}/{p['fallback']}/{p['warnings']}/{p['dropped']}"
            for n, p in zip(names, pages)))


def d2h_per_call(launched, runs):
    """Device-to-host copies per call in a profiler window."""
    return sum(n for k, n in launched.items() if "DtoH" in k) / runs


def one_d2h_per_call(fn, what, call):
    """Device-to-host copies per call of ``fn`` (3 calls a profiler window):
    a window can lose a thread's last events (a ragged window reads under
    1), never make a copy, so up to five windows, one of which must read
    exactly 1 and none more -> (copies per call, device ops per call)."""
    windows = []
    while len(windows) < 5 and 1.0 not in windows:
        _, _, n_ops, launched = profiled(fn, runs=3)
        windows.append(d2h_per_call(launched, 3))
    check(windows[-1] == 1 and max(windows) <= 1, f"{what}: device-to-host copies per {call} "
          f"{windows} in successive profiler windows, 1 expected")
    if len(windows) > 1:
        log(f"{what}: device-to-host copies per {call} in successive profiler windows "
            f"{windows} (a ragged window lost records)")
    return windows[-1], n_ops


def check_fused_program(prog, page, sizes, executor, det, what):
    """One fused page enqueued under torch.cuda.set_sync_debug_mode("error")
    (the detector's real forward, not the painted map): nothing may wait for
    the card before the wire's readback; then profiled (one_d2h_per_call):
    exactly one device-to-host copy per call -> numbers."""
    import torch

    with unpainted(det):
        prog(page, page.hw, *sizes, executor=executor)  # stages the maps
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            wire = prog.enqueue(page, page.hw, *sizes, executor=executor)
        except RuntimeError as e:
            raise SmokeFailure(f"{what}: the fused program waited for the card before its "
                               f"readback: {e}") from e
        finally:
            torch.cuda.set_sync_debug_mode(0)
        nbytes = wire.numel()
        wire.cpu()
    d2h, n_ops = one_d2h_per_call(lambda: prog(page, page.hw, *sizes, executor=executor),
                                  what, "fused program call")
    log(f"{what}: the fused program enqueued with torch.cuda.set_sync_debug_mode('error'): "
        f"no wait for the card before the readback of its {nbytes:,}-byte wire; profiled: "
        f"{d2h:.0f} device-to-host copy and {n_ops:.0f} device ops per call")
    return dict(wire_bytes=nbytes, d2h_per_call=d2h, device_ops_per_call=n_ops)


def route_numbers(what, card, one, batch, n_pages):
    """Both routes of ``one`` (a page) and ``batch(k)`` (``n_pages`` pages at
    max_in_flight k), in turns: ms per page, batch pages/s at 1 and
    IN_FLIGHT, and one page profiled: wall, device busy, idle share,
    device ops (kernels and copies) and device-to-host copies -> numbers."""
    ms = {r: v * 1e3 for r, v in interleaved({r: on_route(r, one) for r in ROUTES}).items()}
    s = interleaved({(r, k): on_route(r, lambda k=k: batch(k))
                     for r in ROUTES for k in (1, IN_FLIGHT)}, runs=2)
    numbers = {}
    for r in ROUTES:
        wall, device, n_ops, launched = on_route(r, lambda: profiled(one, runs=3))()
        busy = sum(device.values())
        numbers[r] = dict(ms_per_page=ms[r],
                          batch_pages_s={str(k): n_pages / s[(r, k)] for k in (1, IN_FLIGHT)},
                          profiled_wall_ms=wall, device_busy_ms=busy,
                          idle_share=1 - busy / wall, device_ops_per_page=n_ops,
                          d2h_per_page=d2h_per_call(launched, 3))
    for r, n in numbers.items():
        log(f"{what}: {r} route: {n['ms_per_page']:.1f} ms/page (median of 5, routes in "
            f"turns); batch of {n_pages} pages {n['batch_pages_s']['1']:.2f} pages/s at "
            f"max_in_flight=1, {n['batch_pages_s'][str(IN_FLIGHT)]:.2f} at {IN_FLIGHT} "
            f"(median of 2); one page profiled {n['profiled_wall_ms']:.1f} ms wall, device "
            f"busy {n['device_busy_ms']:.1f} ms (idle share {n['idle_share']:.2f}), "
            f"{n['device_ops_per_page']:.0f} device ops, {n['d2h_per_page']:.0f} "
            f"device-to-host copies per page; card {card}")
    return numbers


def _models(da):
    return (da.text_detector.model, da.text_recognizer.model,
            da.layout.layout_parser.model, da.layout.table_structure_recognizer.model)


def same_weights(dst, src, recognizer=True):
    """Load ``src``'s four models' weights into ``dst``'s, in place (but
    the recognizer's where ``recognizer`` is false: another model)."""
    for i, (d, s) in enumerate(zip(_models(dst), _models(src))):
        if recognizer or i != 1:
            d.load_state_dict(s.state_dict())


def _document_in_page(doc, w, h, what):
    """Every box of the schema inside the page, every score finite."""
    boxes = ([p.box for p in doc.paragraphs] + [f.box for f in doc.figures]
             + [p.box for f in doc.figures for p in f.paragraphs]
             + [t.box for t in doc.tables] + [c.box for t in doc.tables for c in t.cells])
    for x1, y1, x2, y2 in boxes:
        check(0 <= x1 <= x2 <= w and 0 <= y1 <= y2 <= h, f"{what}: box off the page")
    for word in doc.words:
        check(all(0 <= x <= w and 0 <= y <= h for x, y in word.points),
              f"{what}: word {word.points} off the page")
        check(math.isfinite(word.det_score) and math.isfinite(word.rec_score),
              f"{what}: a word's score is not finite")


def export_all(doc, img, name):
    """JSON, Markdown, CSV and HTML under build/chip_smoke/document/; the
    JSON must read back as model_dump, the HTML file hold convert_html's
    print of the schema."""
    from yomitoku_tpu_torch.export import convert_html

    out = OUT / "document"
    out.mkdir(parents=True, exist_ok=True)
    doc.to_json(str(out / f"{name}.json"))
    check(json.loads((out / f"{name}.json").read_text(encoding="utf-8")) == doc.model_dump(),
          f"{name}: the JSON export does not read back as the schema")
    doc.to_markdown(str(out / f"{name}.md"), img=img)
    doc.to_csv(str(out / f"{name}.csv"), img=img)
    printed = doc.to_html(str(out / f"{name}.html"), img=img)
    want, _ = convert_html(doc, str(out / f"{name}.html"), False, True, False, img)
    check(printed == want and (out / f"{name}.html").read_text(encoding="utf-8") == want
          and bool(want.strip()) == bool(doc.paragraphs or doc.tables or doc.figures),
          f"{name}: the HTML export is not convert_html's print of the schema")
    return ["json", "md", "csv", "html"]


def _first_difference(got, want, path="schema"):
    """Where two model_dump trees first part, for a failure message."""
    if isinstance(want, dict) and isinstance(got, dict):
        for k in want:
            if got.get(k) != want[k]:
                return _first_difference(got.get(k), want[k], f"{path}.{k}")
    if isinstance(want, list) and isinstance(got, list):
        if len(got) != len(want):
            return f"{path}: {len(got)} items against {len(want)}"
        for i, (g, w) in enumerate(zip(got, want)):
            if g != w:
                return _first_difference(g, w, f"{path}[{i}]")
    return f"{path}: {str(got)[:120]} against {str(want)[:120]}"


def check_same(got, want, what):
    g, w = got.model_dump(), want.model_dump()
    check(g == w, f"{what}: {_first_difference(g, w)}")


def prepared_analyzer(table):
    """Phase 9's analyzer: ``DocumentAnalyzer(device="cuda")`` with its
    score heads made findable on ``table`` (sample_table.png) and the
    detector painted (paint_detector)."""
    from yomitoku_tpu_torch.document_analyzer import DocumentAnalyzer

    t0 = time.perf_counter()
    da = DocumentAnalyzer(device="cuda")
    findable(da, table)
    paint_detector(da.text_detector)
    log(f"document: DocumentAnalyzer(device='cuda') built and its score heads spread, "
        f"balanced and thinned in {time.perf_counter() - t0:.1f} s (dbnetv2_1, "
        f"parseq-large-v4_1, rtdetrv2v2, rtdetrv2; seed-0 weights; the detector's map "
        f"painted with each page's lines after its forward)")
    return da


def document_pages(ctx, sample, table):
    """The three pages of phase 9 and five more cut from them with other
    line counts (several share a recognizer batch bucket, so an AR loop)."""
    lines_page = ctx["page"]
    pitch = 28  # synthetic_lines_page's
    pages = {"sample_table": table, "sample_text": sample, "lines_136": lines_page}
    for n in (20, 24, 50, 100):
        pages[f"lines_{n}"] = lines_page[:n * pitch + 16]
    pages["sample_text_top"] = sample[: sample.shape[0] // 2]
    return pages


def _line_gaps(rec, img, quads):
    """Each line's least top-2 logit gap over its greedy decode up to its
    first EOS: the recognizer on the CPU, f32, from the page route's
    crops."""
    import numpy as np
    import torch

    from yomitoku_tpu_torch.ops import device_crop as dc

    canvas = tuple(rec._cfg.data.img_size)
    mats, wh = dc.line_homographies(quads, canvas)
    x = dc.sample_lines(dc.DevicePage(img, "cpu").dev, torch.from_numpy(mats),
                        torch.from_numpy(np.asarray(wh, np.int32)), out_hw=canvas)
    logits = rec.model.forward_logits(x * (1.0 / 127.5) - 1.0)
    top2 = logits.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    ids = logits.argmax(-1)
    eos = (ids == rec.model.eos_id).int().cumsum(-1)
    upto = (eos == 0) | ((eos == 1) & (ids == rec.model.eos_id))
    return torch.where(upto, gap, torch.full_like(gap, float("inf"))).amin(-1).tolist()


def _boxes(doc):
    return ([p.box for p in doc.paragraphs] + [t.box for t in doc.tables]
            + [c.box for t in doc.tables for c in t.cells] + [f.box for f in doc.figures])


def _structure(doc):
    """What the aggregation made of the words, without boxes and scores:
    paragraphs, tables' cells and figures with their contents and order."""
    para = lambda p: (p.contents, p.role, p.direction, p.order)  # noqa: E731
    return ([para(p) for p in doc.paragraphs],
            [(t.order, [(c.row, c.col, c.row_span, c.col_span, c.contents)
                        for c in t.cells]) for t in doc.tables],
            [(f.order, f.direction, [para(p) for p in f.paragraphs]) for f in doc.figures])


#: the largest difference between the two routes' region-model scores of
#: one table (sorted top-k) that bf16 rounding explains: the routes run the
#: region model on other batches (four slots and the chunked rest against
#: all of a page's tables), and bf16 convolutions and GEMMs round apart by
#: batch size; a wrong crop moves the scores by far more
ROUTE_SCORE_LIMIT = 5e-2
#: four table boxes (cx, cy, w, h in [0, 1]) and their logits, for the pages
#: whose tables fill the four slots exactly (pinned_tables)
FOUR_TABLES = [((0.27, 0.2, 0.42, 0.26), 4.0), ((0.73, 0.2, 0.42, 0.26), 3.5),
               ((0.27, 0.62, 0.42, 0.3), 3.0), ((0.73, 0.66, 0.42, 0.3), 2.5)]


@contextlib.contextmanager
def region_rows(module):
    """Each region's top-k rows as ``module``'s host filter sees them, on
    either route: [((w, h), (k, 6) rows)] in call order."""
    import numpy as np

    post = module.postprocessor
    own = post.__dict__.get("filter_packed")
    real = post.filter_packed
    seen = []

    def spy(packed, orig_sizes, threshold):
        sizes = np.asarray(orig_sizes, np.float32).reshape(-1, 2)
        for row, (w, h) in zip(np.asarray(packed), sizes):
            seen.append(((int(w), int(h)), row.copy()))
        return real(packed, orig_sizes, threshold)

    post.filter_packed = spy
    try:
        yield seen
    finally:
        if own is None:
            del post.filter_packed
        else:
            post.filter_packed = own


@contextlib.contextmanager
def pinned_tables(module, tables=FOUR_TABLES, model=None):
    """A layout parser's output pinned after its real forward: ``tables``
    [(cxcywh, table logit)] in its first queries, no other query a table
    (on ``model``, a replica of the parser's model, where given)."""
    import torch

    label = next(i for i, c in module.label_mapper.items() if c == "tables")

    def hook(mod, inputs, out):
        logits, boxes = out["pred_logits"].clone(), out["pred_boxes"].clone()
        logits[..., label] = -8.0
        for q, (box, logit) in enumerate(tables):
            logits[:, q] = -8.0
            logits[:, q, label] = logit
            boxes[:, q] = torch.tensor(box, dtype=boxes.dtype, device=boxes.device)
        return {**out, "pred_logits": logits, "pred_boxes": boxes}

    handle = (model or module.model).decoder.register_forward_hook(hook)
    try:
        yield
    finally:
        handle.remove()


def check_routes_agree(fused, unfused, rows, what):
    """The fused and the unfused route's pages alike: the same words (quads
    and strings), the same tables through the region model (``rows``:
    {route: region_rows of the page}; their crops' sizes), and each table's
    region-model scores within ROUTE_SCORE_LIMIT (sorted top-k) -> numbers:
    the tables, those whose cells differ between the routes (bf16 batch
    rounding near the threshold; not gated), and the largest score
    difference."""
    import numpy as np

    check([(w.points, w.content) for w in fused.words]
          == [(w.points, w.content) for w in unfused.words],
          f"{what}: the routes' words differ ({len(fused.words)} against "
          f"{len(unfused.words)})")
    by_size = {r: {} for r in rows}
    for r, seen in rows.items():
        for size, row in seen:
            by_size[r].setdefault(size, row)
    check(sorted(size for size, _ in rows["fused"]) == sorted(size for size, _ in
                                                              rows["unfused"]),
          f"{what}: other tables reached the region model on the two routes: "
          f"{sorted(by_size['fused'])} against {sorted(by_size['unfused'])}")
    d_score = max([float(np.abs(np.sort(by_size["fused"][k][:, 1])
                                - np.sort(by_size["unfused"][k][:, 1])).max())
                   for k in by_size["fused"]] or [0.0])
    check(d_score <= ROUTE_SCORE_LIMIT,
          f"{what}: a table's region-model scores part by {d_score:.4f} between the routes "
          f"(limit {ROUTE_SCORE_LIMIT})")
    cells = lambda d: {(t.box[2] - t.box[0], t.box[3] - t.box[1]): len(t.cells)  # noqa: E731
                       for t in d.tables}
    got, want = cells(fused), cells(unfused)
    differ = sorted(k for k in got.keys() | want.keys() if got.get(k) != want.get(k))
    return dict(tables=len(by_size["fused"]), cells_differ=len(differ),
                cells=[(k, got.get(k), want.get(k)) for k in differ], max_d_score=d_score)


def check_four_tables(da, table, what):
    """sample_table.png with its layout pinned to four tables, which fill
    the four slots: the region model runs on the same four crops on both
    routes, a batch of four each, so the two routes' schemas are equal, bit
    for bit."""
    lp = da.layout.layout_parser if hasattr(da, "layout") else da.layout_parser
    with pinned_tables(lp), slot_stats() as slots:
        fused = da(table)[0]
        with _env(YOMITOKU_TPU_NO_FUSED_PAGE="1"):
            unfused = da(table)[0]
    check([(p["tables"], p["hits"]) for p in slots] == [(4, 4)],
          f"{what}: the four pinned tables did not fill the four slots: {slots}")
    check_same(fused, unfused, f"{what}: four pinned tables, fused against unfused route")
    log(f"{what}: sample_table.png with its layout pinned to four tables (four slot hits): "
        f"the fused route's schema equals the unfused route's, bit for bit "
        f"({len(fused.tables)} tables)")


def f32_card_vs_cpu(da, img, model_names=None, what="document"):
    """The analyzer in f32 on the card against the CPU, the same weights,
    the page route and the fused page program on both
    (YOMITOKU_TPU_DEVICE_CROPS=1 on the CPU), the
    full memory-K/V cache: equal counts, boxes within 1 px, strings equal
    where the CPU's greedy decode has every top-2 gap at least 1e-4 ->
    numbers.  ``model_names``: the OCR modules' models where not the
    defaults ({"text_detector": .., "text_recognizer": ..}, as ``da``'s)."""
    import numpy as np
    import torch

    from yomitoku_tpu_torch.document_analyzer import DocumentAnalyzer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32 = {"dtype": torch.float32}
    names = {k: {"model_name": v} for k, v in (model_names or {}).items()}
    configs = {"ocr": {k: {**f32, **names.get(k, {})} for k in ("text_detector",
                                                              "text_recognizer")},
               "layout_analyzer": {"layout_parser": f32,
                                   "table_structure_recognizer": f32}}
    with _env(YOMITOKU_TPU_INT8_KV="0"):
        card = DocumentAnalyzer(configs=configs, device="cuda")
        cpu = DocumentAnalyzer(configs={"ocr": names} if names else None, device="cpu")
    same_weights(card, da)  # bf16 values, in f32
    same_weights(cpu, card)
    paint_detector(card.text_detector)
    paint_detector(cpu.text_detector)
    got, _, _ = card(img)
    torch.cuda.synchronize()
    with _env(YOMITOKU_TPU_DEVICE_CROPS="1"):
        t0 = time.perf_counter()
        want, _, _ = cpu(img)
        cpu_s = time.perf_counter() - t0
    check(card._fused_page_program is not None and cpu._fused_page_program is not None,
          "f32 analyzer: the card or the CPU did not take the fused route")
    counts = lambda d: (len(d.words), len(d.paragraphs), len(d.figures),  # noqa: E731
                        [len(t.cells) for t in d.tables])
    log(f"{what}: f32 analyzer on a {img.shape[1]}x{img.shape[0]} page: the CPU took "
        f"{cpu_s:.1f} s; words, paragraphs, figures, cells per table: card "
        f"{counts(got)}, CPU {counts(want)}")
    check(counts(got) == counts(want), "f32 analyzer: card and CPU counts differ")
    d_quad = max([int(np.abs(np.subtract(g.points, w.points)).max())
                  for g, w in zip(got.words, want.words)] or [0])
    d_box = max([int(np.abs(np.subtract(g, w)).max())
                 for g, w in zip(_boxes(got), _boxes(want))] or [0])
    check(d_quad <= 1 and d_box <= 1,
          f"f32 analyzer: quads part by {d_quad} px, boxes by {d_box} px (limit 1)")
    differ = [i for i, (g, w) in enumerate(zip(got.words, want.words))
              if g.content != w.content]
    gaps = _line_gaps(cpu.text_recognizer, img, [want.words[i].points for i in differ])
    check(all(gap < 1e-4 for gap in gaps),
          f"f32 analyzer: {sum(g >= 1e-4 for g in gaps)} words differ outside near-ties")
    if not differ:
        check(_structure(got) == _structure(want),
              "f32 analyzer: paragraphs, cells or figures differ in contents or order")
    log(f"{what}: f32 card vs CPU: quads within {d_quad} px, boxes within {d_box} px "
        f"(limit 1); strings equal on {len(got.words) - len(differ)} of "
        f"{len(got.words)} words, {len(differ)} exempt at a near-tie (top-2 gap < 1e-4)"
        + ("; paragraphs, tables, cells' contents, figures and order equal"
           if not differ else "; contents not compared"))
    return dict(cpu_s=cpu_s, max_quad_px=d_quad, max_box_px=d_box,
                words=len(got.words), near_tie_words=len(differ))


def phase_document(card, ctx):
    """The DocumentAnalyzer path, the CUDA defaults (the page route, the
    int8 memory-K/V cache) -> (launches by path, numbers)."""
    with _env(YOMITOKU_TPU_INT8_KV=None, YOMITOKU_TPU_INT8_ENCODER=None,
              YOMITOKU_TPU_HOST_CROPS=None, YOMITOKU_TPU_DEVICE_CROPS=None,
              YOMITOKU_TPU_REC_WIDTH_BUCKETS=None):
        return _phase_document(card, ctx)


def _phase_document(card, ctx):
    from concurrent.futures import ThreadPoolExecutor

    import cv2
    import torch

    from yomitoku_tpu_torch import ops
    from yomitoku_tpu_torch.data.functions import shortest_edge_size
    from yomitoku_tpu_torch.document_analyzer import DocumentAnalyzer
    from yomitoku_tpu_torch.ocr import ocr_aggregate
    from yomitoku_tpu_torch.ops.device_crop import DevicePage
    from yomitoku_tpu_torch.schemas import DocumentAnalyzerSchema, OCRSchema

    numbers = {}
    sample = cv2.imread(str(ROOT / "demo" / "sample_text.png"))
    table = cv2.imread(str(ROOT / "demo" / "sample_table.png"))
    da = ctx["document_analyzer"] = prepared_analyzer(table)
    pages = document_pages(ctx, sample, table)
    main = ("sample_table", "sample_text", "lines_136")

    # path document_page: the three pages on the fused route (the
    # default), counted, with the slots of each page
    paths = {}
    tsr = da.layout.table_structure_recognizer
    rows = {r: {} for r in ROUTES}
    with slot_stats() as slots, region_rows(tsr) as seen:
        ops.reset_launches()
        docs = {}
        for name in main:
            docs[name] = da(pages[name])[0]
            rows["fused"][name] = list(seen)
            seen.clear()
        torch.cuda.synchronize()
        paths["document_page"] = dict(ops.launches)
    log(f"document: document_page launches {paths['document_page']}")
    check(all(paths["document_page"][k] > 0 for k in DOCUMENT_KERNELS),
          f"a kernel of the document path was never launched: {paths['document_page']}")
    check(len(slots) == len(main), f"document: {len(slots)} fused pages of {len(main)}")
    check_attention_routes("document")
    check_gemm_routes("document")
    check_deform_routes("document", paths["document_page"]["ms_deformable_attention"])
    log_slots(slots, main, "document")
    check_slots(slots, "document")
    numbers["slots"] = dict(zip(main, slots))

    # path document_unfused: the same pages on the unfused route, counted,
    # and the two routes' pages alike
    with _env(YOMITOKU_TPU_NO_FUSED_PAGE="1"), region_rows(tsr) as seen:
        ops.reset_launches()
        unfused = {}
        for name in main:
            unfused[name] = da(pages[name])[0]
            rows["unfused"][name] = list(seen)
            seen.clear()
        torch.cuda.synchronize()
        paths["document_unfused"] = dict(ops.launches)
    log(f"document: document_unfused launches {paths['document_unfused']}")
    check(all(paths["document_unfused"][k] > 0 for k in DOCUMENT_KERNELS),
          f"a kernel of the unfused document path was never launched: "
          f"{paths['document_unfused']}")
    agree = numbers["routes_agree"] = {
        name: check_routes_agree(docs[name], unfused[name],
                                 {r: rows[r][name] for r in ROUTES}, f"document: {name}")
        for name in main}
    log("document: bf16 fused route against the unfused route: the same words (quads and "
        "strings) and the same tables through the table recognizer, its scores within "
        f"{ROUTE_SCORE_LIMIT} (" + "; ".join(
            f"{n}: {a['tables']} tables, max |d score| {a['max_d_score']:.4f}, cells differ on "
            f"{a['cells_differ']} {a['cells']}" for n, a in agree.items()) + ")")
    check_four_tables(da, table, "document")

    prog = da._ensure_fused_program()
    det_cfg = da.text_detector._cfg.data
    sizes = (shortest_edge_size(*table.shape[:2], det_cfg.shortest_size, det_cfg.limit_size),
             tuple(da.layout.layout_parser._cfg.data.img_size),
             tuple(da.layout.table_structure_recognizer._cfg.data.img_size))
    numbers["fused_program"] = check_fused_program(
        prog, DevicePage(table, "cuda"), sizes, da._workers, da.text_detector, "document")
    for name, doc in docs.items():
        h, w = pages[name].shape[:2]
        doc = DocumentAnalyzerSchema.model_validate(doc.model_dump())
        _document_in_page(doc, w, h, name)
        formats = export_all(doc, pages[name], name)
        log(f"document: {name} {w}x{h}: {len(doc.words)} words, {len(doc.paragraphs)} "
            f"paragraphs, {len(doc.tables)} tables ({sum(len(t.cells) for t in doc.tables)} "
            f"cells, {sum(bool(c.contents) for t in doc.tables for c in t.cells)} with "
            f"text), {len(doc.figures)} figures; exported as {', '.join(formats)}")
    t = docs["sample_table"]
    check(any(tb.cells for tb in t.tables) and t.paragraphs and t.figures,
          "sample_table.png: no table with cells, paragraph or figure")
    numbers["counts"] = {name: dict(words=len(d.words), paragraphs=len(d.paragraphs),
                                    tables=len(d.tables), figures=len(d.figures),
                                    cells=sum(len(tb.cells) for tb in d.tables))
                         for name, d in docs.items()}

    # composition: the modules one at a time on one DevicePage
    page = DevicePage(table, "cuda")
    det, _ = da.text_detector(table, page=page)
    lay, _ = da.layout(table, page=page)
    rec, _ = da.text_recognizer(table, det.points, page=page)
    ocr = OCRSchema(words=ocr_aggregate(det, rec))
    composed = DocumentAnalyzerSchema(**da.aggregate(ocr, lay))
    check_same(on_route("unfused", lambda: da(table))()[0], composed,
               "analyzer against its modules one at a time")
    log("document: sample_table.png through the analyzer's unfused route (detector and "
        "layout on two threads) equals the detector, layout analyzer, recognizer, "
        "ocr_aggregate and aggregate called one at a time on one DevicePage: words, "
        "paragraphs, tables, cells' contents, figures and order")

    # path document_batch: a fresh analyzer, its AR graphs captured while
    # other pages run, against one __call__ per page on `da`
    names = list(pages)
    want = {name: da(pages[name])[0] for name in names}
    cold = DocumentAnalyzer(device="cuda")
    same_weights(cold, da)
    paint_detector(cold.text_detector)
    for run in (1, 2):
        ops.reset_launches()
        with timed_ar_lock(cold.text_recognizer.model) as lock:
            t0 = time.perf_counter()
            got = cold.batch([pages[n] for n in names], max_in_flight=IN_FLIGHT)
            torch.cuda.synchronize()
            took = time.perf_counter() - t0
        if run == 1:
            paths["document_batch"] = dict(ops.launches)
            log(f"document: document_batch launches {paths['document_batch']}")
            check(all(paths["document_batch"][k] > 0 for k in DOCUMENT_KERNELS),
                  f"a kernel of the batch path was never launched: {paths['document_batch']}")
        for name, (doc, _, _) in zip(names, got):
            check_same(doc, want[name], f"batch run {run}, page {name}")
        loops = sorted(cold.text_recognizer.model._ar_loops)
        numbers[f"batch_run_{run}"] = dict(s=took, ar_lock_held_s=lock.held,
                                           ar_lock_waited_s=lock.waited)
        log(f"document: batch run {run} ({'cold' if run == 1 else 'warm'}) of "
            f"{len(names)} pages at max_in_flight={IN_FLIGHT}: {took:.2f} s, the AR "
            f"loop's lock held {lock.held:.2f} s and waited on {lock.waited:.2f} s in all "
            f"threads; every page equals its own __call__ on a second analyzer; AR "
            f"loops {loops}")
    del cold
    torch.cuda.empty_cache()

    # f32 on the card against the CPU, on the top 400 rows of
    # sample_table.png (on the CPU the whole page took 50 s, its top half 44)
    numbers["f32"] = f32_card_vs_cpu(da, table[:400])
    torch.cuda.empty_cache()

    # timings (not gated)
    def host(fn):
        def run():
            with _env(YOMITOKU_TPU_HOST_CROPS="1"):
                return fn()
        return run

    timed = ("sample_table", "sample_text")
    fns = {}
    for name in timed:
        for r in ROUTES:
            fns[(name, r)] = on_route(r, lambda p=pages[name]: da(p))
        fns[(name, "host")] = host(lambda p=pages[name]: da(p))
    ms = {k: v * 1e3 for k, v in interleaved(fns).items()}
    numbers["ms_per_page"] = {name: dict(fused_route=ms[(name, "fused")],
                                         unfused_route=ms[(name, "unfused")],
                                         host_route=ms[(name, "host")]) for name in timed}
    log("document: analyzer ms/page, fused / unfused page route / host route: " + "; ".join(
        f"{name} {ms[(name, 'fused')]:.1f} / {ms[(name, 'unfused')]:.1f} / "
        f"{ms[(name, 'host')]:.1f}" for name in timed)
        + f"; median of 5, routes in turns; card {card}")

    batch = [pages[n] for n in names]
    numbers["routes"] = route_numbers(
        "document (sample_table.png)", card, lambda: da(table),
        lambda k: da.batch(batch, max_in_flight=k), len(batch))

    def both(pool):
        page = DevicePage(table, "cuda")
        futures = [pool.submit(da.text_detector, table, page),
                   pool.submit(da.layout, table, page)]
        return [f.result() for f in futures]

    def on_fresh_threads():
        with ThreadPoolExecutor(max_workers=2) as pool:
            return both(pool)

    def detector():
        return da.text_detector(table, page=DevicePage(table, "cuda"))

    def detector_new_thread():
        with ThreadPoolExecutor(max_workers=1) as pool:
            return pool.submit(detector).result()

    par = interleaved({
        "both": lambda: both(da._workers),
        "both_fresh_threads": on_fresh_threads,
        "detector": detector,
        "layout": lambda: da.layout(table, page=DevicePage(table, "cuda")),
        "detector_new_thread": detector_new_thread,
    })
    torch.backends.cudnn.enabled = False
    try:
        par.update({f"{k}_no_cudnn": v for k, v in interleaved({
            "detector": detector, "detector_new_thread": detector_new_thread}).items()})
    finally:
        torch.backends.cudnn.enabled = True
    numbers["detector_layout_ms"] = {k: v * 1e3 for k, v in par.items()}
    ms = numbers["detector_layout_ms"]
    log(f"document: detector and layout analyzer on the analyzer's two threads "
        f"{ms['both']:.1f} ms ({ms['both_fresh_threads']:.1f} ms on two new threads) "
        f"against {ms['detector']:.1f} + {ms['layout']:.1f} = "
        f"{ms['detector'] + ms['layout']:.1f} ms called alone; the detector alone on a new "
        f"thread {ms['detector_new_thread']:.1f} ms, and with cuDNN off "
        f"{ms['detector_no_cudnn']:.1f} ms on this thread, "
        f"{ms['detector_new_thread_no_cudnn']:.1f} ms on a new one (sample_table.png, one "
        f"DevicePage each; median of 5, in turns); card {card}")
    (OUT / "document.json").write_text(json.dumps(numbers, indent=1))
    return paths, numbers


class TimedLock:
    """A lock that sums the seconds its holders waited for it and held it."""

    def __init__(self):
        import threading

        self.lock, self.mu = threading.Lock(), threading.Lock()
        self.waited = self.held = 0.0
        self._since = {}

    def __enter__(self):
        import threading

        t0 = time.perf_counter()
        self.lock.acquire()
        t1 = time.perf_counter()
        with self.mu:
            self.waited += t1 - t0
            self._since[threading.get_ident()] = t1
        return self

    def __exit__(self, *exc):
        import threading

        with self.mu:
            self.held += time.perf_counter() - self._since.pop(threading.get_ident())
        self.lock.release()


@contextlib.contextmanager
def timed_ar_lock(model):
    """A PARSeq model's AR-loop lock timed for the block (TimedLock)."""
    timed = TimedLock()
    real, model._ar_lock = model._ar_lock, timed
    try:
        yield timed
    finally:
        model._ar_lock = real


# ------------------------------------------------------------------ phase 10


#: the PDFs phase 10 renders and runs the CLI on, with their page counts
CLI_PDFS = {"sample": ("sample.pdf", 2), "scan": ("sample_scan.pdf", 1)}
#: the host C++ libraries of the PDF engine
PDF_LIBRARIES = ("rasterizer", "ccitt", "jbig2")
#: phase 10's outputs
CLI_OUT = OUT / "cli"


def text_layer(path):
    """The strings a searchable PDF's text layer shows, per page: each
    ``Tj`` operand of the page's content decoded through its font's
    ToUnicode CMap (the port's own PDF parser)."""
    from yomitoku_tpu_torch.data.pdf.cos import Keyword, Name, Parser
    from yomitoku_tpu_torch.data.pdf.document import PdfDocument
    from yomitoku_tpu_torch.data.pdf.render import _parse_tounicode

    doc = PdfDocument(str(path))
    pages = []
    for i in range(doc.n_pages):
        page = doc.get_page(i)
        resources = doc.resolve(page.get(Name("Resources"))) or {}
        cmaps = {}
        for name, font in (doc.resolve(resources.get(Name("Font"))) or {}).items():
            tounicode = doc.resolve(font).get(Name("ToUnicode"))
            cmaps[str(name)] = (_parse_tounicode(doc.get_stream_data(doc.resolve(tounicode)))
                                if tounicode is not None else {})
        parser = Parser(doc.get_page_content(page), 0)
        operands, cmap, shown = [], {}, []
        while True:
            parser.skip_ws()
            if parser.pos >= len(parser.data):
                break
            obj = parser.parse_object()
            if not isinstance(obj, Keyword):
                operands.append(obj)
                continue
            if str(obj) == "Tf":
                cmap = cmaps.get(str(operands[0]), {})
            elif str(obj) == "Tj":
                codes = operands[-1]
                shown.append("".join(chr(cmap.get(int.from_bytes(codes[j:j + 2], "big"),
                                                  0xFFFD))
                                     for j in range(0, len(codes), 2)))
            operands = []
        pages.append(shown)
    return pages


def words_missing_from_layer(shown, doc):
    """The words of ``doc`` (a DocumentAnalyzerSchema) that the page's text
    layer ``shown`` (text_layer) does not hold -> (missing contents, the
    number of words looked for).  Looked for: every word the writer places,
    those inside a paragraph, cell or figure paragraph (0.7-contained)
    with text and a box of some height and width; a horizontal word as one
    string, a vertical one (in full width) as a run of one-character
    strings; a character the embedded font has no glyph for matches any."""
    import re

    from yomitoku_tpu_torch.utils import searchable_pdf
    from yomitoku_tpu_torch.utils.jp_text import to_full_width

    cmap = searchable_pdf._EmbeddedFont(searchable_pdf.FONT_PATH).cmap
    whole = "\x00".join(shown)
    runs = "".join(shown)  # a vertical word's characters, one string each
    missing, placed = [], 0
    # a word inside a cell and a paragraph is placed twice, looked for once
    words = {id(w): w for w in searchable_pdf._collect_sorted_words(doc)}
    for word in words.values():
        x1, y1, x2, y2 = searchable_pdf._poly2rect(word.points)
        if not word.content or x2 <= x1 or y2 <= y1:
            continue
        placed += 1
        vertical = word.direction == "vertical"
        text = to_full_width(word.content) if vertical else word.content
        pattern = "".join(re.escape(c) if cmap.get(ord(c), 0) else "." for c in text)
        if not re.search(pattern, runs if vertical else whole, re.S):
            missing.append(word.content)
    return missing, placed


class _TimedPages:
    """A PdfPageIterator whose iteration sums the seconds its pages take
    to render."""

    def __init__(self, pages, clock):
        self.pages, self.clock = pages, clock

    def __len__(self):
        return len(self.pages)

    def __getitem__(self, index):
        return self.pages[index]

    def __iter__(self):
        it = iter(self.pages)
        while True:
            t0 = time.perf_counter()
            try:
                page = next(it)
            except StopIteration:
                return
            finally:
                self.clock["render_s"] += time.perf_counter() - t0
            yield page


@contextlib.contextmanager
def cli_harness(src):
    """The CLI module with its DocumentAnalyzer, load_pdf and
    create_searchable_pdf wrapped: after the CLI's own construction, each
    analyzer takes ``src``'s weights (phase 9's findable score heads) and
    its detector is painted (paint_detector); the wrappers sum the seconds
    of construction, PDF render, ``batch`` and the searchable-PDF writer
    into the yielded clock, and list the analyzers built with their
    arguments."""
    import torch

    from yomitoku_tpu_torch.cli import main as cli

    clock = dict(construct_s=0.0, render_s=0.0, analyze_s=0.0, writer_s=0.0, built=[])
    real = (cli.DocumentAnalyzer, cli.load_pdf, cli.create_searchable_pdf)

    def make(**kwargs):
        t0 = time.perf_counter()
        da = real[0](**kwargs)
        same_weights(da, src)
        paint_detector(da.text_detector)
        batch = da.batch

        def timed_batch(imgs, *args, **kw):
            t1 = time.perf_counter()
            out = batch(imgs, *args, **kw)
            torch.cuda.synchronize()
            clock["analyze_s"] += time.perf_counter() - t1
            return out

        da.batch = timed_batch
        clock["built"][:] = [(kwargs, da)]  # the latest only: the card keeps one
        clock["construct_s"] += time.perf_counter() - t0
        return da

    def writer(*args, **kwargs):
        t0 = time.perf_counter()
        out = real[2](*args, **kwargs)
        clock["writer_s"] += time.perf_counter() - t0
        return out

    cli.DocumentAnalyzer = make
    cli.load_pdf = lambda *a, **k: _TimedPages(real[1](*a, **k), clock)
    cli.create_searchable_pdf = writer
    try:
        yield cli, clock
    finally:
        cli.DocumentAnalyzer, cli.load_pdf, cli.create_searchable_pdf = real


def run_cli(cli, clock, name, pdf, flags):
    """``yomitoku_torch demo/<pdf> <flags> -o build/chip_smoke/cli/<name>
    -d cuda`` in this process -> (seconds, the run's clock, its files)."""
    out = CLI_OUT / name
    argv = sys.argv
    sys.argv = ["yomitoku_torch", str(ROOT / "demo" / pdf), *flags, "-o", str(out),
                "-d", "cuda"]
    before = {k: v for k, v in clock.items() if k != "built"}
    t0 = time.perf_counter()
    try:
        cli.main()
    finally:
        sys.argv = argv
    import torch

    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    spent = {k: clock[k] - before[k] for k in before}
    files = sorted(p for p in out.rglob("*") if p.is_file())
    check(files and all(p.stat().st_size > 0 for p in files),
          f"cli {name}: an output is missing or empty: {[p.name for p in files]}")
    return took, spent, files


def expected_cli_files(stem, n_pages, ext, vis=False, combine=False):
    names = [f"demo_{stem}.{ext}"] if combine else [
        f"demo_{stem}_p{i}.{ext}" for i in range(1, n_pages + 1)]
    if vis:
        names += [f"demo_{stem}_p{i}_{kind}.jpg" for i in range(1, n_pages + 1)
                  for kind in ("ocr", "layout")]
    return sorted(names)


#: the routes of the bf16 kernels: an f32 path launches none of them
BF16_ROUTES = {"attention": ("wgmma", "wgmma_small"), "gemm": ("wgmma", "wgmma_small"),
               "conv": ("wgmma", "wgmma_small", "wgmma_split")}


def route_counts():
    """The launch counters by route of ops/_common.py, copied."""
    from yomitoku_tpu_torch.ops import _common

    return {"attention": dict(_common.attention_route_launches),
            "gemm": dict(_common.gemm_route_launches),
            "gemm_int8": dict(_common.gemm_int8_route_launches),
            "conv": dict(_common.conv_route_launches),
            "deform": dict(_common.deform_route_launches)}


def cli_html(cli, clock, pages, card):
    """``-f html`` and ``-f html --combine`` on demo/sample.pdf: each
    page's file the port's ``convert_html`` of that analyzer's ``__call__``
    on the page with the CLI's flags, the combined file the pages joined by
    a line break; the printer's ms per page -> (runs, numbers)."""
    from yomitoku_tpu_torch.export import convert_html

    sample, n = CLI_PDFS["sample"]
    runs = {}
    took, spent, files = run_cli(cli, clock, "html", sample, ["-f", "html"])
    runs["html"] = dict(s=took, **spent)
    check([p.name for p in files] == expected_cli_files("sample", n, "html"),
          f"cli html: files {[p.name for p in files]}")
    _, da = clock["built"][-1]
    printed, ms, elements = [], [], []
    for i, (page, path) in enumerate(zip(pages, files), 1):
        doc = da(page)[0]
        flags = dict(ignore_line_break=False, export_figure=False, export_figure_letter=False,
                     img=page, figure_width=200, figure_dir="figures")
        want, _ = convert_html(doc, str(path), **flags)
        got = path.read_text(encoding="utf-8")
        check(got == want and want.strip(), f"cli html page {i}: the file is not the port's "
              f"convert_html of __call__ on the page ({len(got)} against {len(want)} chars)")
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            convert_html(doc, str(path), **flags)
            times.append((time.perf_counter() - t0) * 1e3)
        ms.append(statistics.median(times))
        elements.append(len(doc.paragraphs) + len(doc.tables))
        printed.append(want)
    took, spent, combined = run_cli(cli, clock, "html_combine", sample,
                                    ["-f", "html", "--combine"])
    runs["html_combine"] = dict(s=took, **spent)
    check([p.name for p in combined] == expected_cli_files("sample", n, "html", combine=True),
          f"cli html --combine: files {[p.name for p in combined]}")
    check(combined[0].read_text(encoding="utf-8") == "\n".join(printed),
          "cli html --combine: the file is not the pages' prints joined")
    check("lxml" not in sys.modules, "cli html: lxml was loaded")
    numbers = dict(pages=n, convert_html_ms=ms, elements=elements,
                   chars=[len(t) for t in printed],
                   s=runs["html"]["s"], combine_s=runs["html_combine"]["s"])
    log(f"cli: -f html on demo/{sample}: each page's file equals the port's convert_html of "
        f"the analyzer's __call__ on it ({', '.join(map(str, numbers['chars']))} chars; "
        f"{', '.join(map(str, elements))} paragraphs and tables); -f html --combine holds "
        f"them joined; lxml never loaded; convert_html (fragments, read and print) "
        f"{', '.join(f'{v:.2f}' for v in ms)} ms per page (median of 5); the runs "
        f"{runs['html']['s']:.2f} s and {runs['html_combine']['s']:.2f} s end to end; "
        f"card {card}")
    return runs, numbers


def cli_f32(cli, clock, pages, card):
    """Path ``cli_f32``: ``-f json`` with YOMITOKU_TPU_DTYPE=f32 set
    before the CLI builds its analyzer, counted: every model in f32, kernels
    1-5 launched and none on a bf16 route, each page's JSON equal to that
    analyzer's ``__call__``; then again, timed -> (launches, runs, routes)."""
    import torch

    from yomitoku_tpu_torch import ops
    from yomitoku_tpu_torch.export import convert_json

    sample, n = CLI_PDFS["sample"]
    runs = {}
    with _env(YOMITOKU_TPU_DTYPE="f32"):
        ops.reset_launches()
        took, spent, files = run_cli(cli, clock, "json_f32", sample, ["-f", "json"])
        torch.cuda.synchronize()
        launched, routes = dict(ops.launches), route_counts()
        runs["json_f32"] = dict(s=took, **spent)
        _, da = clock["built"][-1]
        log(f"cli: path cli_f32 launches {launched}; by route {routes}")
        dtypes = {str(m.dtype) for m in _models(da)}
        check(dtypes == {"torch.float32"}, f"cli f32: the models compute in {dtypes}")
        check(all(launched[k] > 0 for k in DOCUMENT_KERNELS),
              f"a kernel of the f32 CLI path was never launched: {launched}")
        bf16 = {k: {r: routes[k][r] for r in rs if routes[k][r]} for k, rs in BF16_ROUTES.items()}
        check(not any(bf16.values()) and routes["attention"]["fma"] > 0
              and routes["gemm"]["fma"] > 0,
              f"cli f32: launches on a bf16 route {bf16}, or none on the f32 kernels: {routes}")
        check([p.name for p in files] == expected_cli_files("sample", n, "json"),
              f"cli json f32: files {[p.name for p in files]}")
        words = []
        for i, (page, path) in enumerate(zip(pages, files), 1):
            doc = da(page)[0]
            want = convert_json(doc, None, False, page, False).model_dump()
            got = json.loads(path.read_text(encoding="utf-8"))
            check(got == want, f"cli json f32 page {i} against the f32 analyzer's __call__: "
                  f"{_first_difference(got, want)}")
            words.append(len(doc.words))
        took, spent, _ = run_cli(cli, clock, "json_f32_warm", sample, ["-f", "json"])
        runs["json_f32_warm"] = dict(s=took, **spent)
    log(f"cli: YOMITOKU_TPU_DTYPE=f32 yomitoku_torch demo/{sample} -f json: every model in "
        f"f32, no launch on a bf16 route, each page's JSON equal to the f32 analyzer's "
        f"__call__ ({words} words)")
    return launched, runs, routes


#: what the YOMITOKU_TPU_NATIVE_DIR subprocess runs: the libraries loaded,
#: and one fused_mlp launch in f32 against its plain version
NATIVE_DIR_SCRIPT = """
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from yomitoku_tpu_torch import ops
from yomitoku_tpu_torch.ops import _build
t0 = time.perf_counter()
lib = _build.library()
hosts = [_build.host_library(stem)._name for stem in sys.argv[2:]]
load_s = time.perf_counter() - t0
torch.backends.cuda.matmul.allow_tf32 = False
gen = torch.Generator().manual_seed(0)
x, w1, b1, w2, b2 = (torch.randn(shape, generator=gen).cuda() * scale for shape, scale in (
    ((400, 768), 1.0), ((768, 3072), 768 ** -0.5), ((3072,), 0.1), ((3072, 768), 3072 ** -0.5),
    ((768,), 0.1)))
ops.reset_launches()
got = ops.fused_mlp(x, w1, b1, w2, b2)
torch.cuda.synchronize()
want = ops.fused_mlp_reference(x, w1, b1, w2, b2)
print(json.dumps(dict(library=str(lib.path), build_seconds=lib.build_seconds, hosts=hosts,
                      load_s=load_s, launches=ops.launches["fused_mlp"],
                      max_abs_err=float((got - want).abs().max()),
                      max_ref=float(want.abs().max()))))
"""


def native_dir_check(card):
    """YOMITOKU_TPU_NATIVE_DIR: a fresh directory of hard links to the
    kernel library and the host libraries this process built; a subprocess
    with the variable naming it loads them from there without a build and
    holds one fused_mlp launch to its plain version -> numbers."""
    import shutil

    from yomitoku_tpu_torch.ops import _build

    stems = ("dbnet_post", *PDF_LIBRARIES)
    built = [_build.library().path] + [Path(_build.host_library(s)._name) for s in stems]
    native = OUT / "native_dir"
    shutil.rmtree(native, ignore_errors=True)
    native.mkdir(parents=True)
    for path in built:
        os.link(path, native / path.name)
    before = sorted(p.name for p in native.iterdir())
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", NATIVE_DIR_SCRIPT, str(ROOT), *stems],
                          capture_output=True, text=True, timeout=300, cwd=ROOT,
                          env={**os.environ, "YOMITOKU_TPU_NATIVE_DIR": str(native)})
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"YOMITOKU_TPU_NATIVE_DIR subprocess failed: "
          f"{proc.stderr[-3000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    loaded = [Path(got["library"])] + [Path(h) for h in got["hosts"]]
    check([p.parent for p in loaded] == [native] * len(loaded)
          and [p.name for p in loaded] == [p.name for p in built]
          and got["build_seconds"] == 0.0
          and sorted(p.name for p in native.iterdir()) == before,
          f"YOMITOKU_TPU_NATIVE_DIR: the subprocess loaded {loaded} (build "
          f"{got['build_seconds']} s), not the links in {native}")
    limit = 1e-4 * got["max_ref"] + 1e-5
    check(got["launches"] == 1 and got["max_abs_err"] <= limit,
          f"YOMITOKU_TPU_NATIVE_DIR: fused_mlp launches {got['launches']}, max|d| "
          f"{got['max_abs_err']:.3g} against its plain version (limit {limit:.3g})")
    log(f"cli: YOMITOKU_TPU_NATIVE_DIR={native.relative_to(ROOT)}: a subprocess loaded the "
        f"kernel library and {len(stems)} host libraries from its hard links, no build "
        f"({got['load_s']:.2f} s to load; {wall:.1f} s for the process); fused_mlp f32 "
        f"(400, 768) -> 3072 -> 768 launched once, max|d| {got['max_abs_err']:.3g} against its "
        f"plain version (limit {limit:.3g}); card {card}")
    return dict(got, process_s=wall, limit=limit)


def phase_cli(card, ctx):
    """The CLI backend (yomitoku_tpu_torch.cli.main) on demo/sample.pdf,
    the CUDA defaults -> (launches by path, numbers)."""
    with _env(YOMITOKU_TPU_INT8_KV=None, YOMITOKU_TPU_INT8_ENCODER=None,
              YOMITOKU_TPU_HOST_CROPS=None, YOMITOKU_TPU_DEVICE_CROPS=None,
              YOMITOKU_TPU_REC_WIDTH_BUCKETS=None):
        return _phase_cli(card, ctx)


def _phase_cli(card, ctx):
    import shutil

    import cv2
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from yomitoku_tpu_torch import ops
    from yomitoku_tpu_torch.data import load_pdf
    from yomitoku_tpu_torch.export import convert_json
    from yomitoku_tpu_torch.ops import _build

    numbers = {}
    # the PDF engine's host C++, built here (g++; loaded only where a build
    # of the same sources exists), then the two demo PDFs
    built = {}
    for stem in PDF_LIBRARIES:
        t0 = time.perf_counter()
        _build.host_library(stem)
        built[stem] = time.perf_counter() - t0
    numbers["host_build_s"] = dict(built, total=sum(built.values()))
    log(f"cli: host C++ of the PDF engine built and loaded in "
        f"{numbers['host_build_s']['total']:.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in built.items()) + ")")
    rendered = {}
    for key, (pdf, n) in CLI_PDFS.items():
        t0 = time.perf_counter()
        pages = list(load_pdf(ROOT / "demo" / pdf, dpi=200))
        ms = (time.perf_counter() - t0) * 1e3 / max(len(pages), 1)
        ink = [float((p.mean(axis=2) < 128).mean()) for p in pages]
        log(f"cli: demo/{pdf} rendered at 200 dpi: {len(pages)} pages "
            f"{[p.shape for p in pages]}, {ms:.0f} ms/page, ink share "
            f"{', '.join(f'{v:.3f}' for v in ink)}")
        check(len(pages) == n and all(p.shape == (3556, 2667, 3) and p.dtype.name == "uint8"
                                      for p in pages), f"demo/{pdf}: pages of the wrong shape")
        check(all(v > 0.005 for v in ink), f"demo/{pdf}: a rendered page is blank")
        rendered[key] = pages
        numbers[f"render_ms_per_page_{key}"] = ms

    src = ctx.get("document_analyzer")
    if src is None:
        src = ctx["document_analyzer"] = prepared_analyzer(
            cv2.imread(str(ROOT / "demo" / "sample_table.png")))
    shutil.rmtree(CLI_OUT, ignore_errors=True)
    sample, n = CLI_PDFS["sample"]
    paths, runs = {}, {}
    with cli_harness(src) as (cli, clock):
        # path cli: the first run, counted
        ops.reset_launches()
        took, spent, files = run_cli(cli, clock, "json", sample, ["-f", "json"])
        torch.cuda.synchronize()
        paths["cli"] = dict(ops.launches)
        log(f"cli: path cli launches {paths['cli']}")
        check(all(paths["cli"][k] > 0 for k in DOCUMENT_KERNELS),
              f"a kernel of the CLI path was never launched: {paths['cli']}")
        check_attention_routes("cli")
        check_gemm_routes("cli")
        check_deform_routes("cli", paths["cli"]["ms_deformable_attention"])
        runs["json"] = dict(s=took, **spent)
        kwargs, da = clock["built"][-1]
        check(kwargs["device"] == "cuda" and kwargs["num_devices"] is None
              and kwargs["configs"]["ocr"]["text_recognizer"]["model_name"]
              == "parseq-large-v4_1"
              and kwargs["configs"]["ocr"]["text_detector"]["model_name"] == "dbnetv2_1",
              f"cli: the analyzer was built with {kwargs}")
        check([p.name for p in files] == expected_cli_files("sample", n, "json"),
              f"cli json: files {[p.name for p in files]}")
        docs, rows = [], []
        tsr = da.layout.table_structure_recognizer
        with slot_stats() as slots, region_rows(tsr) as seen:
            for i, (page, path) in enumerate(zip(rendered["sample"], files), 1):
                doc = da(page)[0]
                rows.append({"fused": list(seen)})
                seen.clear()
                want = convert_json(doc, None, False, page, False).model_dump()
                got = json.loads(path.read_text(encoding="utf-8"))
                check(got == want, f"cli json page {i} against __call__: "
                      f"{_first_difference(got, want)}")
                check(doc.words, f"cli json page {i}: no words")
                docs.append(doc)
        log(f"cli: -f json: each page's JSON equals convert_json of the analyzer's "
            f"__call__ on the same rendered page ({[len(d.words) for d in docs]} words, "
            f"{[len(d.paragraphs) for d in docs]} paragraphs, "
            f"{[len(d.tables) for d in docs]} tables)")
        names = [f"page {i}" for i in range(1, n + 1)]
        check(len(slots) == n, f"cli: {len(slots)} fused pages of {n}")
        log_slots(slots, names, "cli")
        check_slots(slots, "cli")
        numbers["slots"] = dict(zip(names, slots))
        agree = []
        with _env(YOMITOKU_TPU_NO_FUSED_PAGE="1"), region_rows(tsr) as seen:
            for name, page, doc, r in zip(names, rendered["sample"], docs, rows):
                unfused = da(page)[0]
                r["unfused"] = list(seen)
                seen.clear()
                agree.append(check_routes_agree(doc, unfused, r, f"cli: {name}"))
        numbers["routes_agree"] = agree
        log("cli: bf16 fused route against the unfused route on both pages: the same words "
            f"and tables, the table recognizer's scores within {ROUTE_SCORE_LIMIT} (" + "; ".join(
                f"{name}: {a['tables']} tables, max |d score| {a['max_d_score']:.4f}, cells "
                f"differ on {a['cells_differ']}" for name, a in zip(names, agree)) + ")")
        # the CLI's chunk (here both pages) through batch at its default
        # max_in_flight against one page at a time, on the same analyzer,
        # on both routes
        numbers["routes"] = route_numbers(
            "cli (sample.pdf, 200 dpi)", card, lambda: da(rendered["sample"][0]),
            lambda k: da.batch(rendered["sample"], max_in_flight=k), n)
        numbers["chunk_pages_s"] = numbers["routes"]["fused"]["batch_pages_s"]

        # --num_devices 2: one card, so no replica; the analyzer's batch
        # takes the page axis (a chunk of one page, YOMITOKU_TPU_DP_CHUNK's
        # default), whose batches are __call__'s: the JSON of the default run
        with batch_call_pages() as calls, _env(YOMITOKU_TPU_DP_CHUNK=None):
            took, spent, dp_files = run_cli(cli, clock, "json_num_devices_2", sample,
                                            ["-f", "json", "--num_devices", "2"])
        kwargs, _ = clock["built"][-1]
        check(kwargs["num_devices"] == 2, f"cli: --num_devices 2 built {kwargs}")
        check(calls == [1] * n, f"cli --num_devices 2: batch_call pages {calls}, the page "
              f"axis at one page a chunk expected ({[1] * n})")
        check([p.name for p in dp_files] == [p.name for p in files],
              f"cli --num_devices 2: files {[p.name for p in dp_files]}")
        for a, b in zip(files, dp_files):
            check(a.read_bytes() == b.read_bytes(),
                  f"cli --num_devices 2: {b.name} differs from the default run's")
        runs["json_num_devices_2"] = dict(s=took, **spent)
        log(f"cli: -f json --num_devices 2 on {torch.cuda.device_count()} card(s): the page "
            f"axis (batch_call pages {calls}), {took:.2f} s; every JSON file equals the default "
            f"run's, byte for byte")

        # timed: a second -f json run, and one under torch.profiler
        took, spent, _ = run_cli(cli, clock, "json_warm", sample, ["-f", "json"])
        runs["json_warm"] = dict(s=took, **spent)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            took, spent, _ = run_cli(cli, clock, "json_profiled", sample, ["-f", "json"])
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA) / 1e6
        runs["json_profiled"] = dict(s=took, device_busy_s=busy, idle_share=1 - busy / took,
                                     **spent)

        for name, flags, stem, kw in (
                ("md_vis", ["-f", "md", "-v"], "sample", dict(ext="md", vis=True)),
                ("csv", ["-f", "csv"], "sample", dict(ext="csv")),
                ("pdf", ["-f", "pdf"], "sample", dict(ext="pdf")),
                ("pdf_combine", ["-f", "pdf", "--combine"], "sample",
                 dict(ext="pdf", combine=True)),
                ("scan", ["-f", "json"], "sample_scan", dict(ext="json"))):
            pdf = CLI_PDFS["scan"][0] if stem == "sample_scan" else sample
            took, spent, files = run_cli(cli, clock, name, pdf, flags)
            runs[name] = dict(s=took, **spent)
            want = expected_cli_files(stem, CLI_PDFS["scan" if stem == "sample_scan"
                                                     else "sample"][1], **kw)
            check([p.name for p in files] == want,
                  f"cli {name}: files {[p.name for p in files]} against {want}")
            log(f"cli: {' '.join(flags)} on demo/{pdf}: {took:.2f} s, "
                f"{len(files)} files, {sum(p.stat().st_size for p in files)} bytes")
        html_runs, numbers["html"] = cli_html(cli, clock, rendered["sample"], card)
        runs.update(html_runs)
        paths["cli_f32"], f32_runs, numbers["f32_routes"] = cli_f32(
            cli, clock, rendered["sample"], card)
        runs.update(f32_runs)

    del da, src
    torch.cuda.empty_cache()

    # the searchable PDF: two pages whose text layers hold the words
    combined = CLI_OUT / "pdf_combine" / "demo_sample.pdf"
    layer = text_layer(combined)
    check(len(layer) == n, f"searchable PDF: {len(layer)} pages, want {n}")
    placed = []
    for i, (shown, doc) in enumerate(zip(layer, docs), 1):
        missing, looked_for = words_missing_from_layer(shown, doc)
        check(not missing and looked_for > 0, f"searchable PDF page {i}: of "
              f"{looked_for} words, not in the text layer: {missing[:5]}")
        placed.append(f"{looked_for} of {len(doc.words)}")
    log(f"cli: -f pdf --combine: {n} pages, their text layers ({[len(s) for s in layer]} "
        f"strings) hold every word the writer places ({', '.join(placed)} words: those "
        f"inside a paragraph, cell or figure); the writer took "
        f"{runs['pdf_combine']['writer_s'] * 1e3:.0f} ms for {n} pages")

    numbers["runs"] = runs
    warm = runs["json_warm"]
    pages_s = n / warm["s"]
    other = warm["s"] - warm["construct_s"] - warm["render_s"] - warm["analyze_s"]
    numbers["json"] = dict(
        pages=n, pages_s=pages_s, pages_s_without_construction=n / (
            warm["s"] - warm["construct_s"]),
        per_page_ms=dict(construct=warm["construct_s"] * 1e3 / n,
                         render=warm["render_s"] * 1e3 / n,
                         analyzer=warm["analyze_s"] * 1e3 / n,
                         export_and_rest=other * 1e3 / n),
        cold_s=runs["json"]["s"], idle_share=runs["json_profiled"]["idle_share"],
        device_busy_s=runs["json_profiled"]["device_busy_s"],
        writer_ms_per_page=runs["pdf"]["writer_s"] * 1e3 / n)
    j = numbers["json"]
    log(f"cli: yomitoku_torch demo/sample.pdf -f json: {pages_s:.3f} pages/s end to end "
        f"({warm['s']:.2f} s for {n} pages, the analyzer's construction included; "
        f"{j['pages_s_without_construction']:.3f} pages/s without it; first run "
        f"{j['cold_s']:.2f} s); per page: construction {j['per_page_ms']['construct']:.0f} ms, "
        f"PDF render {j['per_page_ms']['render']:.0f} ms, analyzer (batch) "
        f"{j['per_page_ms']['analyzer']:.0f} ms, export and the rest "
        f"{j['per_page_ms']['export_and_rest']:.0f} ms; searchable-PDF writer "
        f"{j['writer_ms_per_page']:.0f} ms/page; card {card}")
    log(f"cli: one -f json run under torch.profiler: {runs['json_profiled']['s']:.2f} s wall, "
        f"device busy {j['device_busy_s']:.3f} s, idle share {j['idle_share']:.3f}; "
        f"card {card}")
    f32 = runs["json_f32_warm"]
    numbers["json_f32"] = dict(
        pages_s=n / f32["s"], pages_s_without_construction=n / (f32["s"] - f32["construct_s"]),
        cold_s=runs["json_f32"]["s"], analyzer_ms_per_page=f32["analyze_s"] * 1e3 / n)
    k = numbers["json_f32"]
    log(f"cli: yomitoku_torch demo/sample.pdf -f json in f32 (YOMITOKU_TPU_DTYPE=f32): "
        f"{k['pages_s']:.3f} pages/s end to end against bf16's {pages_s:.3f} in this run "
        f"({k['pages_s_without_construction']:.3f} against "
        f"{j['pages_s_without_construction']:.3f} without the construction; analyzer "
        f"(batch) {k['analyzer_ms_per_page']:.0f} against {j['per_page_ms']['analyzer']:.0f} "
        f"ms/page; first run {k['cold_s']:.2f} s against {j['cold_s']:.2f} s); card {card}")
    numbers["native_dir"] = native_dir_check(card)
    (OUT / "cli.json").write_text(json.dumps(numbers, indent=1))
    return paths, numbers


# ------------------------------------------------------------------ phase 11


#: the kernels the TableSemanticParser path runs by default
SEMANTIC_KERNELS = DOCUMENT_KERNELS
#: phase 11's outputs
SEMANTIC_OUT = OUT / "semantic"
#: RT-DETRv2 calls per cell-detector chunk of up to 64 tables: the deformable
#: kernel in each of the 6 decoder layers; the attention kernel in the AIFI
#: and the 6 decoder layers
DEFORM_PER_CALL, ATTENTION_PER_CALL = 6, 7


def prepared_semantic_parser(src):
    """``TableSemanticParser(device="cuda", visualize=False)`` with the four
    default models (rtdetrv2v2 layout, rtdetrv2_beta cells at 2,500 queries,
    dbnetv2_1, parseq-large-v4_1), the layout parser, detector and
    recognizer given ``src``'s (phase 9's analyzer's) weights in place, the
    detector painted, and the cell detections pinned after the real forward,
    readback and filter (``utils.synthetic_heads.pinned_filter_packed``:
    with random weights a 2,500-query head passes hundreds of boxes a table,
    whose quadratic host filters would time a load no checkpoint makes)."""
    from yomitoku_tpu_torch.table_semantic_parser import TableSemanticParser

    t0 = time.perf_counter()
    tsp = TableSemanticParser(device="cuda", visualize=False)
    semantic_weights(tsp, src)
    log(f"semantic: TableSemanticParser(device='cuda') built in "
        f"{time.perf_counter() - t0:.1f} s (rtdetrv2v2, rtdetrv2_beta at "
        f"{tsp.cell_detector._cfg.RTDETRTransformerv2.num_queries} queries and "
        f"{tsp.cell_detector._cfg.RTDETRTransformerv2.num_classes} classes, dbnetv2_1, "
        f"parseq-large-v4_1; the cell detector {tsp.cell_detector.model.param_count():,} "
        f"params, {tsp.cell_detector.model.dtype}, seed-0 weights)")
    return tsp


def semantic_weights(tsp, src):
    """``src``'s layout parser, detector and recognizer weights into
    ``tsp``'s, in place; the detector painted; the cell detections
    pinned."""
    from yomitoku_tpu_torch.utils.synthetic_heads import pinned_filter_packed

    for dst, model in ((tsp.layout_parser, src.layout.layout_parser.model),
                       (tsp.text_detector, src.text_detector.model),
                       (tsp.text_recognizer, src.text_recognizer.model)):
        dst.model.load_state_dict(model.state_dict())
    paint_detector(tsp.text_detector)
    cd = tsp.cell_detector
    cd.postprocessor.filter_packed = pinned_filter_packed(cd)


def check_semantic_ids(doc, what):
    """At least one grid and one key-value item; the ids t{i}, g{i},
    kv{i}, p{i} in order, and every cell id a key of its table."""
    grids = sum(len(t.grids) for t in doc.tables)
    kv = sum(len(t.kv_items) for t in doc.tables)
    check(grids >= 1 and kv >= 1, f"{what}: {grids} grids and {kv} key-value items")
    check([t.id for t in doc.tables] == [f"t{i}" for i in range(len(doc.tables))]
          and all([g.id for g in t.grids] == [f"g{i}" for i in range(len(t.grids))]
                  and [k.id for k in t.kv_items] == [f"kv{i}" for i in range(len(t.kv_items))]
                  and all(cid == c.id for cid, c in t.cells.items())
                  for t in doc.tables)
          and [p.id for p in doc.paragraphs] == [f"p{i}" for i in range(len(doc.paragraphs))],
          f"{what}: ids out of order")
    return grids, kv


def _semantic_counts(doc):
    return dict(tables=len(doc.tables), grids=sum(len(t.grids) for t in doc.tables),
                kv_items=sum(len(t.kv_items) for t in doc.tables),
                cells=sum(len(t.cells) for t in doc.tables),
                paragraphs=len(doc.paragraphs), words=len(doc.words))


def semantic_schema(doc):
    """An extraction schema for the rule CLI that names cells of the first
    pinned grid (a value cell by id, the header cells as table columns) and
    the key text of the first key-value item."""
    grid = next(g for t in doc.tables for g in t.grids)
    kv_table = next(t for t in doc.tables if t.kv_items)
    key = kv_table.cells[kv_table.kv_items[0].key[0]]
    return {"fields": [
        {"name": "grid_value", "cell_id": grid.data[-1][0]},
        {"name": "kv_key", "description": key.contents or key.id},
        {"name": "kv_value", "cell_id": kv_table.kv_items[0].value},
        {"name": "grid", "structure": "table", "columns": [
            {"name": f"col{i}", "cell_id": header[-1]}
            for i, header in enumerate(grid.col_headers[:2])]},
    ]}


def phase_semantic(card, ctx):
    """The TableSemanticParser path, the CUDA defaults (the page route, the
    int8 memory-K/V cache) -> (launches by path, numbers)."""
    with _env(YOMITOKU_TPU_INT8_KV=None, YOMITOKU_TPU_INT8_ENCODER=None,
              YOMITOKU_TPU_HOST_CROPS=None, YOMITOKU_TPU_DEVICE_CROPS=None,
              YOMITOKU_TPU_REC_WIDTH_BUCKETS=None):
        return _phase_semantic(card, ctx)


def _phase_semantic(card, ctx):
    import asyncio
    import copy
    import shutil

    import cv2
    import numpy as np
    import torch
    import yaml

    from yomitoku_tpu_torch import ops
    from yomitoku_tpu_torch.cli import extract_rule
    from yomitoku_tpu_torch.extractor import ExtractionSchema, run_rule_extraction
    from yomitoku_tpu_torch.ops._common import attention_route_launches
    from yomitoku_tpu_torch.ops.device_crop import DevicePage
    from yomitoku_tpu_torch.schemas import TableSemanticParserSchema
    from yomitoku_tpu_torch.utils.stagetrace import collect

    numbers = {}
    table = cv2.imread(str(ROOT / "demo" / "sample_table.png"))
    sample = cv2.imread(str(ROOT / "demo" / "sample_text.png"))
    src = ctx.get("document_analyzer")
    if src is None:
        src = ctx["document_analyzer"] = prepared_analyzer(table)
    tsp = prepared_semantic_parser(src)
    cd = tsp.cell_detector
    layout, _ = tsp.layout_parser(table, page=DevicePage(table, "cuda"))
    tables = list(layout.tables)
    check(len(tables) >= 2, f"semantic: the layout parser found {len(tables)} tables on "
          "sample_table.png (two or more wanted: a grid and key-value items)")
    chunks = -(-len(tables) // 64)

    # path semantic: one __call__ on the fused route (the default),
    # counted: the layout parser, the cell detector on the four slots and
    # on a chunk of the tables the slots missed
    paths = {}
    with slot_stats() as slots:
        ops.reset_launches()
        doc, _, _ = tsp(table)
        torch.cuda.synchronize()
        paths["semantic"] = launched = dict(ops.launches)
    check(len(slots) == 1, f"semantic: {len(slots)} fused pages of 1")
    log_slots(slots, ["sample_table"], "semantic")
    check_slots(slots, "semantic")
    numbers["slots"] = slots[0]
    missed = -(-slots[0]["fallback"] // 64)
    log(f"semantic: path semantic launches {launched} ({len(tables)} tables, the slots and "
        f"{missed} chunk of the tables they missed)")
    check(all(launched[k] > 0 for k in SEMANTIC_KERNELS),
          f"a kernel of the semantic path was never launched: {launched}")
    check(launched["ms_deformable_attention"] == DEFORM_PER_CALL * (2 + missed),
          f"semantic: {launched['ms_deformable_attention']} deformable launches, "
          f"{DEFORM_PER_CALL} each for the layout parser, the slots and {missed} chunk(s) of "
          "missed tables expected")
    check_attention_routes("semantic")
    check_gemm_routes("semantic")
    check_deform_routes("semantic", launched["ms_deformable_attention"])

    # path semantic_unfused: the same page on the unfused route, counted;
    # the same grids and key-value items on both routes
    with _env(YOMITOKU_TPU_NO_FUSED_PAGE="1"):
        ops.reset_launches()
        unfused, _, _ = tsp(table)
        torch.cuda.synchronize()
        paths["semantic_unfused"] = launched = dict(ops.launches)
    log(f"semantic: path semantic_unfused launches {launched} ({len(tables)} tables, "
        f"{chunks} cell-detector chunk)")
    check(all(launched[k] > 0 for k in SEMANTIC_KERNELS),
          f"a kernel of the unfused semantic path was never launched: {launched}")
    check(launched["ms_deformable_attention"] == DEFORM_PER_CALL * (1 + chunks),
          f"semantic: {launched['ms_deformable_attention']} deformable launches on the "
          f"unfused route, {DEFORM_PER_CALL} each for the layout parser and {chunks} cell "
          "chunk(s) expected")
    parsed = lambda d: [(t.box, [g.model_dump() for g in t.grids],  # noqa: E731
                         [k.model_dump() for k in t.kv_items]) for t in d.tables]
    check(parsed(doc) == parsed(unfused),
          f"semantic: the routes' grids or key-value items differ: "
          f"{_first_difference(parsed(doc), parsed(unfused))}")
    same = doc.model_dump() == unfused.model_dump()
    log(f"semantic: bf16 fused route against the unfused route on sample_table.png: the same "
        f"tables, grids and key-value items; the whole schema {'equal' if same else 'not equal'}")
    numbers["routes_schema_equal"] = same
    sizes = tsp._fused_sizes(table)
    numbers["fused_program"] = check_fused_program(
        tsp._ensure_fused_program(), DevicePage(table, "cuda"), sizes, tsp._workers,
        tsp.text_detector, "semantic")
    doc = TableSemanticParserSchema.model_validate(doc.model_dump())
    grids, kv = check_semantic_ids(doc, "sample_table.png")
    numbers["counts"] = {"sample_table": _semantic_counts(doc)}
    SEMANTIC_OUT.mkdir(parents=True, exist_ok=True)
    doc.to_json(str(SEMANTIC_OUT / "sample_table.json"))
    log(f"semantic: sample_table.png: {len(doc.tables)} tables ({grids} grids, {kv} key-value "
        f"items, {sum(len(t.cells) for t in doc.tables)} cells, "
        f"{sum(bool(c.contents) for t in doc.tables for c in t.cells.values())} with text), "
        f"{len(doc.paragraphs)} paragraphs, {len(doc.words)} words; ids in order")

    # the cell detector alone on the page's tables, counted: its
    # self-attention over 2,500 queries on "wgmma"
    page = DevicePage(table, "cuda")
    ops.reset_launches()
    cd(table, tables, page=page)
    torch.cuda.synchronize()
    per_call, routes = dict(ops.launches), dict(attention_route_launches)
    log(f"semantic: one CellDetector call on {len(tables)} tables: launches {per_call}, "
        f"attention by route {routes}")
    check(per_call["ms_deformable_attention"] == DEFORM_PER_CALL * chunks
          and per_call["fused_attention_heads"] == ATTENTION_PER_CALL * chunks
          and routes["wgmma"] >= (ATTENTION_PER_CALL - 1) * chunks and routes["fma"] == 0,
          f"semantic: the cell detector's launches {per_call} / routes {routes}: its decoder's "
          "self-attention did not run on wgmma")
    numbers["cell_detector_launches_per_call"] = dict(per_call, attention_routes=routes)

    # batch of three pages at max_in_flight 1 and 4 on both routes, each
    # page equal to its own __call__
    pages = {"sample_table": table, "sample_text": sample,
             "sample_table_top": table[: table.shape[0] // 2]}
    for route in ("page", "unfused", "host"):
        with _env(YOMITOKU_TPU_HOST_CROPS="1" if route == "host" else None,
                  YOMITOKU_TPU_NO_FUSED_PAGE="1" if route == "unfused" else None):
            want = {n: tsp(p)[0].model_dump() for n, p in pages.items()}
            for k in (1, IN_FLIGHT):
                got = tsp.batch(list(pages.values()), max_in_flight=k)
                for name, (g, _, _) in zip(pages, got):
                    gd = g.model_dump()
                    check(gd == want[name], f"semantic: {route} route, batch at "
                          f"max_in_flight={k}, page {name}: {_first_difference(gd, want[name])}")
        numbers["counts"].update({f"{route}_{n}": dict(tables=len(d["tables"]))
                                  for n, d in want.items()})
    log(f"semantic: batch of {len(pages)} pages at max_in_flight 1 and {IN_FLIGHT}, on the page "
        "route (fused, then unfused) and on the host route: every page equals its own "
        "__call__, bit for bit")

    # the rule-extraction CLI in process on sample_table.png, its parser
    # built by the CLI and given this parser's weights
    shutil.rmtree(SEMANTIC_OUT / "cli", ignore_errors=True)
    schema_path = SEMANTIC_OUT / "schema.yaml"
    schema_path.write_text(yaml.safe_dump(semantic_schema(doc), allow_unicode=True),
                           encoding="utf-8")
    built = []
    real = extract_rule.TableSemanticParser

    def make(**kwargs):
        parser = real(**kwargs)
        semantic_weights(parser, src)
        built.append((kwargs, parser))
        return parser

    extract_rule.TableSemanticParser = make
    argv, sys.argv = sys.argv, ["yomitoku_torch_extract", str(ROOT / "demo" / "sample_table.png"),
                                "-s", str(schema_path), "-o", str(SEMANTIC_OUT / "cli"), "-v",
                                "-d", "cuda"]
    try:
        t0 = time.perf_counter()
        extract_rule.main()
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
    finally:
        sys.argv, extract_rule.TableSemanticParser = argv, real
    (kwargs, parser), = built
    check(kwargs == {"configs": {}, "device": "cuda", "visualize": True},
          f"semantic cli: the parser was built with {kwargs}")
    files = sorted(p.name for p in (SEMANTIC_OUT / "cli").iterdir())
    want_files = ["sample_table_p1_extract.json", "sample_table_p1_extract_extract_vis.jpg",
                  "sample_table_p1_layout.jpg", "sample_table_p1_ocr.jpg"]
    check(files == want_files and all((SEMANTIC_OUT / "cli" / f).stat().st_size > 0
                                      for f in files),
          f"semantic cli: files {files}, {want_files} wanted, none empty")
    own, _, _ = parser(table)
    want = run_rule_extraction(own, table, ExtractionSchema.from_yaml(str(schema_path)),
                               outdir=str(SEMANTIC_OUT / "direct"), filename="sample_table")
    got = json.loads((SEMANTIC_OUT / "cli" / "sample_table_p1_extract.json").read_text(
        encoding="utf-8"))
    check(got == want, f"semantic cli: the JSON against run_rule_extraction: "
          f"{_first_difference(got, want)}")
    found = {k: v.get("source") for k, v in got["fields"].items()}
    log(f"semantic: yomitoku_torch_extract sample_table.png -v -d cuda in process: {cli_s:.2f} s "
        f"(the parser's construction included), files {files}; the JSON equals "
        f"run_rule_extraction on the parser's own __call__; fields by source {found}")
    numbers["cli"] = dict(s=cli_s, sources=found)
    del parser, built
    torch.cuda.empty_cache()

    # f32 cell detector on the card against the CPU, 640x640, 2,500 queries
    x1, y1, x2, y2 = map(int, tables[0].box)
    crop = cv2.resize(cv2.cvtColor(table[y1:y2, x1:x2], cv2.COLOR_BGR2RGB), (640, 640),
                      interpolation=cv2.INTER_AREA)
    _rtdetr_f32_vs_cpu(cd._cfg, np.ascontiguousarray(crop)[None], what="semantic")
    torch.cuda.empty_cache()

    # timings (not gated)
    def host(fn):
        def run():
            with _env(YOMITOKU_TPU_HOST_CROPS="1"):
                return fn()
        return run

    ms = {k: v * 1e3 for k, v in interleaved({
        "fused": lambda: tsp(table), "unfused": on_route("unfused", lambda: tsp(table)),
        "host": host(lambda: tsp(table))}).items()}
    numbers["ms_per_page"] = dict(fused_route=ms["fused"], unfused_route=ms["unfused"],
                                  host_route=ms["host"])
    log(f"semantic: TableSemanticParser ms/page on sample_table.png, fused / unfused page "
        f"route / host route: {ms['fused']:.1f} / {ms['unfused']:.1f} / {ms['host']:.1f} "
        f"(median of 5, in turns); card {card}")

    cells = {}
    four = (tables * 4)[:4]
    for n, ts in ((1, tables[:1]), (4, four)):
        wall, device, n_ops, _ = profiled(lambda ts=ts: cd(table, ts, page=page), runs=5)
        busy = sum(device.values())
        cells[str(n)] = dict(ms=wall, device_busy_ms=busy, idle_share=1 - busy / wall,
                             device_ops_per_call=n_ops,
                             deform_ms=sum(v for k, v in device.items() if DEFORM_KERNEL in k),
                             attention_ms=sum(v for k, v in device.items() if "attention" in k))
    numbers["cell_detector"] = cells
    log("semantic: CellDetector per call (the page route, profiled, 5 calls): " + "; ".join(
        f"{n} table{'s' if n != '1' else ''} {c['ms']:.1f} ms wall, device busy "
        f"{c['device_busy_ms']:.1f} ms (idle share {c['idle_share']:.2f}), {c['device_ops_per_call']:.0f} "
        f"device ops, attention {c['attention_ms']:.3f} ms, deformable {c['deform_ms']:.3f} ms"
        for n, c in cells.items()) + f"; card {card}")

    results = asyncio.run(tsp.run_models(table))
    runs = []
    for _ in range(5):
        args = copy.deepcopy(results)
        with collect() as stats:
            t0 = time.perf_counter()
            tsp._finalize(table, *args)
            runs.append(dict(total=time.perf_counter() - t0,
                             aggregate=stats.seconds[("aggregate", "host")],
                             parse=stats.seconds[("semantic", "parse")]))
    host_ms = {k: statistics.median(r[k] for r in runs) * 1e3 for k in runs[0]}
    numbers["host_parse_ms"] = host_ms
    log(f"semantic: the parse's host stage on sample_table.png (_finalize, median of 5): "
        f"{host_ms['total']:.2f} ms, of which the words' aggregation {host_ms['aggregate']:.2f} "
        f"ms and clustering with the grid and key-value parsers {host_ms['parse']:.2f} ms")

    batch = list(pages.values())
    numbers["routes"] = route_numbers(
        "semantic (sample_table.png)", card, lambda: tsp(table),
        lambda k: tsp.batch(batch, max_in_flight=k), len(batch))
    (OUT / "semantic.json").write_text(json.dumps(numbers, indent=1))
    ctx["semantic_parser"] = tsp  # phase 12's
    torch.cuda.empty_cache()
    return paths, numbers



#: phase 12's page-axis chunks (YOMITOKU_TPU_DP_CHUNK): one page, the
#: default and __call__'s batches, and four, the table slots 16 a chunk
DP_CHUNKS = (1, 4)


@contextlib.contextmanager
def batch_call_pages():
    """The page count of every FusedPageAnalysis.batch_call in the block."""
    from yomitoku_tpu_torch.ops import fused_page

    seen = []
    real = fused_page.FusedPageAnalysis.batch_call

    def spy(self, pages_dev, page_hws, *args, **kwargs):
        seen.append(int(pages_dev.shape[0]))
        return real(self, pages_dev, page_hws, *args, **kwargs)

    fused_page.FusedPageAnalysis.batch_call = spy
    try:
        yield seen
    finally:
        fused_page.FusedPageAnalysis.batch_call = real


def chunk_calls(imgs, det_hw, chunk):
    """The batch_call page counts the page axis sends for ``imgs``: one
    call of ``chunk`` pages per chunk of each (padded shape, detector size)
    group, a short chunk padded."""
    groups = {}
    for img in imgs:
        h, w = img.shape[:2]
        key = (-(-h // 512), -(-w // 512), det_hw(img))
        groups[key] = groups.get(key, 0) + 1
    return [chunk] * sum(-(-n // chunk) for n in groups.values())


def dp_batch(obj, imgs, chunk, **kwargs):
    """``obj.batch(imgs)`` with ``num_devices`` 2 at YOMITOKU_TPU_DP_CHUNK
    ``chunk``: on one card dp_mesh(2) is None, so the page axis runs
    without a mesh, as the JAX package's does on one chip (the analyzer's
    attribute is what ``batch`` reads; its modules would make no replica on
    one card)."""
    saved, obj.num_devices = obj.num_devices, 2
    try:
        with _env(YOMITOKU_TPU_DP_CHUNK=str(chunk)):
            return [r[0] for r in obj.batch(imgs, **kwargs)]
    finally:
        obj.num_devices = saved


@contextlib.contextmanager
def region_calls(model):
    """Every forward of a region model in the block: [(input crops, its
    outputs' sigmoid scores (B, Q*C))], clones where the crops lay (the
    host's crops as CPU tensors)."""
    import numpy as np
    import torch

    real, seen = model.forward, []

    def spy(images):
        out = real(images)
        x = (images.detach().clone() if isinstance(images, torch.Tensor)
             else torch.from_numpy(np.array(images)))
        seen.append((x, torch.sigmoid(out["pred_logits"].float()).flatten(1)))
        return out

    model.forward = spy
    try:
        yield seen
    finally:
        del model.forward


def _paired_score_gap(rows):
    """The region model's sorted scores on each table crop of two runs
    (``rows``: {"dp" | "batch": region_rows}), paired greedily by crop
    size, closest first -> (max |d|, the worst crop's size); fails where
    other crops reached the model."""
    import numpy as np

    by_size = {}
    for key, seen in rows.items():
        by_size[key] = {}
        for size, row in seen:
            by_size[key].setdefault(size, []).append(np.sort(row[:, 1])[::-1])
    a, b = by_size["dp"], by_size["batch"]
    check({k: len(v) for k, v in a.items()} == {k: len(v) for k, v in b.items()},
          f"other table crops reached the region model: {sorted(a)} against {sorted(b)}")
    d, worst = 0.0, None
    for k in a:
        dist = np.array([[float(np.abs(x - y).max()) for y in b[k]] for x in a[k]])
        for _ in range(len(a[k])):
            i, j = np.unravel_index(np.argmin(dist), dist.shape)
            if dist[i, j] > d:
                d, worst = float(dist[i, j]), k
            dist[i, :], dist[:, j] = np.inf, np.inf
    return d, worst, sum(len(v) for v in a.values())


def check_page_axis_agrees(got, want, rows, calls, what, words=True):
    """The page axis at a chunk of several pages (or the stage-batched host
    route) against ``batch()``, the layout pinned on both: the same words
    (quads and strings) on every page (``words``; the caller checks them
    where it is False); the same table crops reaching the region model
    (``rows``: {"dp" | "batch": region_rows}); each chunk's input to the
    region model, K crops a page, bit-equal to the K crops ``batch()`` fed
    it for that page (``calls``: {"dp" | "batch": region_calls}), so that
    the slots, the crop maps and the lanes are the same; and the region
    model's sorted scores on the host's rows (paired greedily by crop size,
    closest first) within the model's own batch rounding: the largest
    difference between its outputs on the same crops at the chunk's batch
    and at ``batch()``'s, + 1e-6.  bf16 rounds apart by batch, and random
    weights can flip a query of a table (seen: one crop of 35 by 0.35), so
    a fixed limit fails on rounding; a row that reached another page or
    slot, or a lane fed another crop, fails this gate.  ROUTE_SCORE_LIMIT,
    the page routes' fixed limit, is reported beside it -> numbers."""
    import torch

    if words:
        for i, (g, w) in enumerate(zip(got, want)):
            check([(x.points, x.content) for x in g.words]
                  == [(x.points, x.content) for x in w.words],
                  f"{what}: page {i}: the words differ ({len(g.words)} against {len(w.words)})")
    try:
        d, worst, crops = _paired_score_gap(rows)
    except SmokeFailure as e:
        raise SmokeFailure(f"{what}: {e}") from e
    k = len(calls["batch"][0][0]) if calls["batch"] else 0
    model_d, lanes = 0.0, 0
    for x, scores in calls["dp"]:
        for s in range(0, len(x), k):
            match = [sc for xb, sc in calls["batch"] if len(xb) == k and torch.equal(xb, x[s:s + k])]
            check(match, f"{what}: lane {s // k} of a chunk fed the region model crops that "
                  "batch() fed it for no page")
            d_lane = (scores[s:s + k].sort(-1).values - match[0].sort(-1).values).abs().max()
            model_d = max(model_d, float(d_lane))
            lanes += 1
    check(d <= model_d + 1e-6,
          f"{what}: the region scores on the host's rows part from batch()'s by {d:.6f} (crop "
          f"{worst}), more than the model's own batch rounding on the same crops, "
          f"{model_d:.6f}: a row reached another page or slot")
    return dict(crops=crops, lanes=lanes, max_d_score=d, worst_crop=worst,
                within_limit=d <= ROUTE_SCORE_LIMIT, model_batch_max_d_score=model_d,
                gate=model_d + 1e-6)


def log_agrees(what, route, agree, words="the same words on every page"):
    log(f"{what}: {route} against batch(), the layout pinned to four tables a page on both: "
        f"{words}, the same {agree['crops']} table crops, each of {agree['lanes']} lanes fed "
        f"the region model batch()'s crops bit for bit; the region model's sorted scores part "
        f"by {agree['max_d_score']:.4f} on the host's rows (worst crop {agree['worst_crop']}), "
        f"within its own bf16 batch rounding on the same crops, "
        f"{agree['model_batch_max_d_score']:.4f} (gate: that + 1e-6; the page routes' fixed "
        f"limit {ROUTE_SCORE_LIMIT} {'held' if agree['within_limit'] else 'not held'})")


def check_batch_program(prog, imgs, sizes, executor, det, what):
    """One chunk of pages uploaded and enqueued under
    torch.cuda.set_sync_debug_mode("error") (the detector's real forward):
    nothing may wait for the card before the chunk's readback; then one
    batch_call profiled: one device-to-host copy for the chunk -> numbers."""
    import torch

    from yomitoku_tpu_torch.ops.device_crop import DevicePages

    with unpainted(det):
        pages = DevicePages(imgs, "cuda")
        prog.batch_call(pages.dev, pages.hws, *sizes, executor=executor)  # stages the maps
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            pages = DevicePages(imgs, "cuda")
            wire = prog.enqueue_batch(pages.dev, pages.hws, *sizes, executor=executor)
        except RuntimeError as e:
            raise SmokeFailure(f"{what}: the page axis waited for the card before its "
                               f"readback: {e}") from e
        finally:
            torch.cuda.set_sync_debug_mode(0)
        nbytes = wire.numel()
        wire.cpu()
        d2h, n_ops = one_d2h_per_call(
            lambda: prog.batch_call(pages.dev, pages.hws, *sizes, executor=executor),
            what, "batch_call")
    log(f"{what}: a chunk of {len(imgs)} pages uploaded and enqueued with "
        f"torch.cuda.set_sync_debug_mode('error'): no wait for the card before the readback of "
        f"its {nbytes:,}-byte wire; profiled: {d2h:.0f} device-to-host copy and {n_ops:.0f} "
        f"device ops per batch_call")
    return dict(wire_bytes=nbytes, d2h_per_call=d2h, device_ops_per_call=n_ops,
                pages=len(imgs))


def check_replicas(da, imgs, lines, what):
    """Replicas on the device list [cuda:0, cuda:0] (one card named twice):
    each of the four models split over two copies equals, bit for bit, the
    model itself on each half (the same batches, the same kernels); then
    the page axis with the detector, the layout and the table recognizer
    split over their replicas (chunks of two pages; the layout pinned to
    four tables on both of its copies, which fill the four slots, so that
    no table takes the chunked route) equals one page a chunk -> numbers."""
    import numpy as np
    import torch

    from yomitoku_tpu_torch import document_analyzer as port_da
    from yomitoku_tpu_torch.parallel import make_mesh, runner

    mesh = make_mesh(devices=["cuda:0", "cuda:0"])
    det, rec = da.text_detector, da.text_recognizer
    lp, tsr = da.layout.layout_parser, da.layout.table_structure_recognizer
    cases = {
        "dbnet": (det.model, np.concatenate([det.preprocess_u8(p) for p in imgs[:2]]),
                  lambda m, x: m.forward_u8(x)),
        "layout": (lp.model, np.concatenate([lp.preprocess(p) for p in imgs[:2]]),
                   lambda m, x: m(x)),
        "tsr": (tsr.model, np.stack([d["array"] for d in tsr.preprocess(imgs[0], TABLE_BOXES)]),
                lambda m, x: m(x)),
        "parseq": (rec.model, lines, lambda m, x: m.forward_tokens_device(x)),
    }
    runs = []
    real_run = runner.Replicas.run

    def spy(self, fn, chunks, *static):
        runs.append([len(c) if not isinstance(c, tuple) else len(c[0]) for c in chunks])
        return real_run(self, fn, chunks, *static)

    def flat(out):
        if isinstance(out, dict):
            return [out[k] for k in sorted(out)]
        return list(out) if isinstance(out, tuple) else [out]

    numbers = {}
    runner.Replicas.run = spy
    try:
        for name, (model, x, fn) in cases.items():
            h = len(x) // 2
            with torch.no_grad():
                want = [torch.cat(parts) for parts in zip(*(flat(fn(model, x[s:s + h]))
                                                            for s in (0, h)))]
                model.use_mesh(mesh)
                try:
                    reps = model.replicas()
                    got = flat(fn(model, x))
                    torch.cuda.synchronize()
                finally:
                    model.use_mesh(None)
            check(reps.models[0] is model and reps.models[1] is not model
                  and all(p.device == torch.device("cuda", 0) for p in reps.models[1].parameters()),
                  f"{what}: {name}: the replicas are not two copies on cuda:0")
            check(runs and runs[-1] == [h, h], f"{what}: {name}: replica runs {runs[-1:]}")
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"{what}: {name}: two replicas differ from the model on each half")
            numbers[name] = dict(batch=len(x), per_replica=h)
        # the page axis over replicas, two pages a chunk
        models = [det.model, lp.model, tsr.model]
        pair = imgs[:2]
        real_mesh = port_da.dp_mesh
        with pinned_tables(lp), slot_stats() as slots:
            want = dp_batch(da, pair, 1)
            port_da.dp_mesh = lambda *a, **k: mesh
            runs.clear()
            try:
                for m in models:
                    m.use_mesh(mesh)
                with pinned_tables(lp, model=lp.model.replicas().models[1]), \
                        batch_call_pages() as calls:
                    got = [r[0] for r in da._batch_dp_fused(pair)]
                torch.cuda.synchronize()
            finally:
                port_da.dp_mesh = real_mesh
                for m in models:
                    m.use_mesh(None)
    finally:
        runner.Replicas.run = real_run
    check([(p["tables"], p["hits"]) for p in slots] == [(4, 4)] * 4,
          f"{what}: the four pinned tables did not fill the four slots: {slots}")
    check(calls == [2], f"{what}: batch_call pages {calls} over the replicas, [2] expected")
    check(sorted(runs) == [[1, 1], [1, 1], [4, 4]],
          f"{what}: replica runs {runs}: the detector and the layout one page each, the "
          "table recognizer four slots each expected")
    for i, (g, w) in enumerate(zip(got, want)):
        check_same(g, w, f"{what}: page axis over replicas, page {i} against one page a chunk")
    numbers["page_axis"] = dict(batch_call_pages=calls, replica_runs=runs)
    batches = ", ".join(f"{k} {v['batch']}" for k, v in numbers.items() if k != "page_axis")
    log(f"{what}: replicas on [cuda:0, cuda:0]: DBNet, the layout RT-DETRv2, the table "
        f"recognizer and PARSeq each split over two copies equal the model on each half, bit "
        f"for bit (batches: {batches}); the page axis with the detector, the layout and the "
        f"table recognizer on two replicas (batch_call pages {calls}, replica runs {runs}; "
        f"four pinned tables a page) equals one page a chunk")
    return numbers


def phase_dp(card, ctx):
    """The page axis: DocumentAnalyzer and TableSemanticParser with
    ``num_devices`` 2, the CUDA defaults -> (launches by path, numbers)."""
    with _env(YOMITOKU_TPU_INT8_KV=None, YOMITOKU_TPU_INT8_ENCODER=None,
              YOMITOKU_TPU_HOST_CROPS=None, YOMITOKU_TPU_DEVICE_CROPS=None,
              YOMITOKU_TPU_REC_WIDTH_BUCKETS=None, YOMITOKU_TPU_DP_CHUNK=None,
              YOMITOKU_TPU_DP_DEVICE_DEPTH=None, YOMITOKU_TPU_DP_TAIL_WORKERS=None):
        return _phase_dp(card, ctx)


def _moved_crops(a, b):
    """How many table crops (by size) one run of region_rows holds that the
    other lacks, both ways."""
    from collections import Counter

    ca, cb = Counter(size for size, _ in a), Counter(size for size, _ in b)
    return sum((ca - cb).values()) + sum((cb - ca).values())


def _dp_part(what, obj, imgs, names, det_hw, layout, region, kernels, card):
    """One analyzer on the page axis: ``batch()`` on threads, then the page
    axis at each of DP_CHUNKS (counted together as one path), each route
    gated, timed beside ``batch()`` and profiled -> (launches, numbers).
    Four pages a chunk run the layout model on four pages at once, whose
    bf16 boxes round apart from one page's (random weights: table crops a
    few to tens of pixels apart), so that chunk is gated with the layout
    pinned to four tables a page (``pinned_tables`` on ``layout``), on
    both sides; unpinned, the crops that moved are counted, not gated."""
    import torch

    from yomitoku_tpu_torch import ops

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    numbers, rows, secs = {}, {}, {}
    with region_rows(region) as seen:
        want, secs[f"batch_in_flight_{IN_FLIGHT}"] = timed(
            lambda: [r[0] for r in obj.batch(imgs, max_in_flight=IN_FLIGHT)])
        rows["batch"] = list(seen)
        seen.clear()
        got = {}
        ops.reset_launches()
        for chunk in DP_CHUNKS:
            with batch_call_pages() as calls:
                got[chunk], secs[f"page_axis_chunk_{chunk}"] = timed(
                    lambda: dp_batch(obj, imgs, chunk))
            rows[chunk] = list(seen)
            seen.clear()
            expect = chunk_calls(imgs, det_hw, chunk)
            check(sorted(calls) == sorted(expect),
                  f"{what}: chunk {chunk}: batch_call pages {calls}, {expect} expected")
            numbers[f"batch_call_pages_chunk{chunk}"] = calls
        torch.cuda.synchronize()
        launched = dict(ops.launches)
    log(f"{what}: path {what} launches {launched} (the page axis at chunks of "
        f"{' and '.join(map(str, DP_CHUNKS))} pages; batch_call pages "
        + "; ".join(f"chunk {c}: {numbers[f'batch_call_pages_chunk{c}']}" for c in DP_CHUNKS)
        + ")")
    check(all(launched[k] > 0 for k in kernels),
          f"a kernel of the {what} path was never launched: {launched}")
    check_attention_routes(what)
    check_gemm_routes(what)
    check_deform_routes(what, launched["ms_deformable_attention"])
    for name, g, w in zip(names, got[1], want):
        check_same(g, w, f"{what}: chunk 1, page {name} against batch()")
    log(f"{what}: one page a chunk: every page's schema equals batch()'s, bit for bit "
        f"({len(imgs)} pages)")
    moved = numbers["chunk4_unpinned_crops_moved"] = _moved_crops(rows[4], rows["batch"])
    log(f"{what}: four pages a chunk, unpinned: {moved} of {len(rows[4])} + "
        f"{len(rows['batch'])} table crops differ from batch()'s (the layout's bf16 boxes "
        "at batch 4 against 1; not gated)")
    with pinned_tables(layout), region_rows(region) as seen, region_calls(region.model) as fed:
        want4 = [r[0] for r in obj.batch(imgs, max_in_flight=IN_FLIGHT)]
        pinned, calls = {"batch": list(seen)}, {"batch": list(fed)}
        seen.clear()
        fed.clear()
        got4 = dp_batch(obj, imgs, 4)
        pinned["dp"], calls["dp"] = list(seen), list(fed)
    agree = numbers["chunk4_agrees"] = check_page_axis_agrees(
        got4, want4, pinned, calls, f"{what}: chunk 4, pinned layout")
    log_agrees(what, "four pages a chunk", agree)

    # pages/s beside batch(): the gates' own runs above (the pages ran
    # warm in phases 9 and 11 before, in the full run) and one at
    # max_in_flight 1; one run of each page-axis chunk profiled on the two
    # 1280x960 demo pages twice (one chunk of four same-size pages at four
    # a chunk; the profiler's tables over all the pages' ~200,000 device
    # ops take a minute to build)
    t0 = time.perf_counter()
    _, secs["batch_in_flight_1"] = timed(lambda: obj.batch(imgs, max_in_flight=1))
    numbers["pages_s"] = {k: len(imgs) / v for k, v in sorted(secs.items())}
    prof, four = {}, imgs[:2] * 2
    for c in DP_CHUNKS:
        wall, device, n_ops, launched_p = profiled(lambda c=c: dp_batch(obj, four, c),
                                                   runs=1, warmup=False)
        busy = sum(device.values())
        prof[f"page_axis_chunk_{c}"] = dict(
            wall_ms_per_page=wall / len(four), device_busy_ms_per_page=busy / len(four),
            idle_share=1 - busy / wall, device_ops_per_page=n_ops / len(four),
            d2h_per_page=d2h_per_call(launched_p, 1) / len(four))
    numbers["profiled"] = prof
    numbers["timing_s"] = time.perf_counter() - t0
    log(f"{what}: {len(imgs)} pages, pages/s (one run each: the gates' and one at "
        "max_in_flight 1): " + ", ".join(
        f"{k} {v:.2f}" for k, v in numbers["pages_s"].items()) + "; one run on the two "
        "1280x960 pages twice profiled, per page: "
        + "; ".join(f"{k} {p['wall_ms_per_page']:.1f} ms wall, device busy "
                    f"{p['device_busy_ms_per_page']:.1f} ms (idle share {p['idle_share']:.2f}), "
                    f"{p['device_ops_per_page']:.0f} device ops, {p['d2h_per_page']:.1f} "
                    f"device-to-host copies" for k, p in prof.items()) + f"; card {card}")
    return launched, numbers


def check_f32_chunk(da, imgs, what):
    """The analyzer in f32 on the card (the full memory-K/V cache), the page
    axis at four pages a chunk against one ``__call__`` per page, within
    phase 9's card-vs-CPU limits: equal counts, quads and boxes within 1 px,
    strings equal where the quads are -> numbers."""
    import numpy as np
    import torch

    from yomitoku_tpu_torch.document_analyzer import DocumentAnalyzer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32 = {"dtype": torch.float32}
    configs = {"ocr": {"text_detector": f32, "text_recognizer": f32},
               "layout_analyzer": {"layout_parser": f32, "table_structure_recognizer": f32}}
    with _env(YOMITOKU_TPU_INT8_KV="0"):
        card32 = DocumentAnalyzer(configs=configs, device="cuda")
    same_weights(card32, da)
    paint_detector(card32.text_detector)
    want = [card32(img)[0] for img in imgs]
    with batch_call_pages() as calls:
        got = dp_batch(card32, imgs, 4)
    check(calls == [4], f"{what}: batch_call pages {calls}, one chunk of 4 expected")
    counts = lambda d: (len(d.words), len(d.paragraphs), len(d.figures),  # noqa: E731
                        [len(t.cells) for t in d.tables])
    d_quad = d_box = 0
    differ = 0
    for i, (g, w) in enumerate(zip(got, want)):
        check(counts(g) == counts(w), f"{what}: page {i}: counts {counts(g)} against {counts(w)}")
        d_quad = max([d_quad] + [int(np.abs(np.subtract(a.points, b.points)).max())
                                 for a, b in zip(g.words, w.words)])
        d_box = max([d_box] + [int(np.abs(np.subtract(a, b)).max())
                               for a, b in zip(_boxes(g), _boxes(w))])
        differ += sum(a.content != b.content for a, b in zip(g.words, w.words)
                      if a.points == b.points)
    check(d_quad <= 1 and d_box <= 1,
          f"{what}: quads part by {d_quad} px, boxes by {d_box} px (limit 1)")
    check(differ == 0, f"{what}: {differ} words on equal quads read differently")
    log(f"{what}: f32 page axis, four pages in one chunk, against __call__ per page: counts "
        f"equal, quads within {d_quad} px, boxes within {d_box} px (limit 1), strings equal "
        f"on equal quads ({sum(len(g.words) for g in got)} words)")
    del card32
    torch.cuda.empty_cache()
    return dict(max_quad_px=d_quad, max_box_px=d_box, words=sum(len(g.words) for g in got))


@contextlib.contextmanager
def recognizer_reads(rec):
    """Every host-route read of a text recognizer in the block (its
    ``_infer_padded``, the padding stripped): [(crop bytes, ids)], one per
    line, in call order."""
    import numpy as np

    real, seen = rec._infer_padded, []

    def spy(chunk):
        ids, probs = real(chunk)
        for crop, row in zip(np.asarray(chunk), np.asarray(ids)):
            seen.append((crop.tobytes(), tuple(row.tolist())))
        return ids, probs

    rec._infer_padded = spy
    try:
        yield seen
    finally:
        del rec._infer_padded


def _dp_host_part(da, imgs, what, card):
    """``DocumentAnalyzer.batch`` with ``num_devices`` 2 under
    YOMITOKU_TPU_HOST_CROPS=1 takes the stage-batched host route
    (``_batch_dp_host``: one detector forward a page size, one layout
    forward over every page, one table-recognizer forward over every
    table, one recognizer stream over every line), its launches counted as
    a path of its own, against phase 9's host-route ``batch()`` on threads
    under the gate of four pages a chunk (the layout pinned to four tables
    a page on both): the same quads; the same strings, but for lines whose
    crop the recognizer, fed it bit-equal in both runs, read otherwise in
    its bf16 batch of other lines (counted); the same table crops, each
    page's fed the table recognizer bit-equal to ``batch()``'s, and its
    scores within its own batch rounding -> (launches, numbers)."""
    import torch

    from yomitoku_tpu_torch import ops

    routes = []
    real_host, real_fused = da._batch_dp_host, da._batch_dp_fused
    da._batch_dp_host = lambda pages: routes.append("host") or real_host(pages)
    da._batch_dp_fused = lambda pages: routes.append("fused") or real_fused(pages)
    rec, tsr = da.text_recognizer, da.layout.table_structure_recognizer
    secs = {}
    try:
        with _env(YOMITOKU_TPU_HOST_CROPS="1"), pinned_tables(da.layout.layout_parser), \
                region_rows(tsr) as seen, region_calls(tsr.model) as fed, \
                recognizer_reads(rec) as read:
            t0 = time.perf_counter()
            want = [r[0] for r in da.batch(imgs, max_in_flight=IN_FLIGHT)]
            secs[f"batch_in_flight_{IN_FLIGHT}"] = time.perf_counter() - t0
            rows, calls, lines = {"batch": list(seen)}, {"batch": list(fed)}, {"batch": list(read)}
            seen.clear()
            fed.clear()
            read.clear()
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.perf_counter()
            got = dp_batch(da, imgs, 1)
            torch.cuda.synchronize()
            secs["page_axis_host"] = time.perf_counter() - t0
            launched = dict(ops.launches)
            rows["dp"], calls["dp"], lines["dp"] = list(seen), list(fed), list(read)
    finally:
        del da._batch_dp_host, da._batch_dp_fused
    check(routes == ["host"], f"{what}: the page axis took {routes}, _batch_dp_host expected")
    log(f"{what}: path {what} launches {launched} (the stage-batched host route, "
        f"{len(imgs)} pages)")
    check(all(launched[k] > 0 for k in DOCUMENT_KERNELS),
          f"a kernel of the {what} path was never launched: {launched}")
    for i, (g, w) in enumerate(zip(got, want)):
        check([x.points for x in g.words] == [x.points for x in w.words],
              f"{what}: page {i}: the quads differ ({len(g.words)} against {len(w.words)})")
    read_as = {}
    for crop, ids in lines["batch"]:
        read_as.setdefault(crop, set()).add(ids)
    check(all(crop in read_as for crop, _ in lines["dp"]),
          f"{what}: the recognizer read a crop that batch() never fed it")
    rounded = sum(ids not in read_as[crop] for crop, ids in lines["dp"])
    differ = sum(a.content != b.content for g, w in zip(got, want)
                 for a, b in zip(g.words, w.words))
    check(differ <= rounded,
          f"{what}: {differ} words read differently from batch()'s, where the recognizer "
          f"read {rounded} of its bit-equal crops otherwise: a string reached another line")
    agree = check_page_axis_agrees(got, want, rows, calls, what, words=False)
    log_agrees(what, "the stage-batched host route", agree,
               words=f"the same quads on every page, {differ} strings apart, where the "
               f"recognizer read {rounded} of {len(lines['dp'])} bit-equal line crops otherwise "
               "in its bf16 batch of other lines")
    pages_s = {k: len(imgs) / v for k, v in secs.items()}
    log(f"{what}: {len(imgs)} pages under YOMITOKU_TPU_HOST_CROPS=1, the layout pinned, one "
        "run each: pages/s " + ", ".join(f"{k} {v:.2f}" for k, v in pages_s.items())
        + f"; card {card}")
    return launched, dict(agrees=agree, lines=len(lines["dp"]), lines_read_otherwise=rounded,
                          strings_apart=differ, pages_s=pages_s)


def check_f32_semantic_chunk(tsp, imgs, what):
    """The table semantic parser in f32 on the card (the full memory-K/V
    cache; ``tsp``'s weights, the detector painted and the cell
    detections pinned as phase 11's), the page axis at four pages a chunk
    against one ``__call__`` per page, the layout pinned to four tables a
    page on both, within phase 9's card-vs-CPU limits: equal counts (tables,
    grids, key-value items, cells, paragraphs, words), quads and boxes
    within 1 px, strings equal where the quads are; and the cell
    detector's sorted scores on every table crop (its rows before the
    pinned filter) within 1e-4 of ``__call__``'s -> numbers."""
    import numpy as np
    import torch

    from yomitoku_tpu_torch.table_semantic_parser import TableSemanticParser
    from yomitoku_tpu_torch.utils.synthetic_heads import pinned_filter_packed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32 = {"dtype": torch.float32}
    configs = {k: f32 for k in ("table_detector", "table_cell_parser", "text_detector",
                                "text_recognizer")}
    with _env(YOMITOKU_TPU_INT8_KV="0"):
        tsp32 = TableSemanticParser(configs=configs, device="cuda", visualize=False)
    for name in ("layout_parser", "cell_detector", "text_detector", "text_recognizer"):
        getattr(tsp32, name).model.load_state_dict(getattr(tsp, name).model.state_dict())
    paint_detector(tsp32.text_detector)
    cd = tsp32.cell_detector
    cd.postprocessor.filter_packed = pinned_filter_packed(cd)
    rows = {}
    with pinned_tables(tsp32.layout_parser), region_rows(cd) as seen:
        want = [tsp32(img)[0] for img in imgs]
        rows["batch"] = list(seen)
        seen.clear()
        with batch_call_pages() as calls:
            got = dp_batch(tsp32, imgs, 4)
        rows["dp"] = list(seen)
    check(calls == [4], f"{what}: batch_call pages {calls}, one chunk of 4 expected")
    try:
        d_score, worst, crops = _paired_score_gap(rows)
    except SmokeFailure as e:
        raise SmokeFailure(f"{what}: {e}") from e
    check(d_score <= 1e-4, f"{what}: the cell detector's f32 scores part by {d_score:.2e} on "
          f"crop {worst} (limit 1e-4)")

    def boxes(doc):
        return ([t.box for t in doc.tables] + [c.box for t in doc.tables for c in t.cells.values()]
                + [p.box for p in doc.paragraphs])

    d_quad = d_box = differ = 0
    for i, (g, w) in enumerate(zip(got, want)):
        check(_semantic_counts(g) == _semantic_counts(w),
              f"{what}: page {i}: counts {_semantic_counts(g)} against {_semantic_counts(w)}")
        d_quad = max([d_quad] + [int(np.abs(np.subtract(a.points, b.points)).max())
                                 for a, b in zip(g.words, w.words)])
        d_box = max([d_box] + [int(np.abs(np.subtract(a, b)).max())
                               for a, b in zip(boxes(g), boxes(w))])
        differ += sum(a.content != b.content for a, b in zip(g.words, w.words)
                      if a.points == b.points)
    check(d_quad <= 1 and d_box <= 1,
          f"{what}: quads part by {d_quad} px, boxes by {d_box} px (limit 1)")
    check(differ == 0, f"{what}: {differ} words on equal quads read differently")
    counts = [_semantic_counts(g) for g in got]
    log(f"{what}: f32 table semantic parser, four pages in one chunk, against __call__ per "
        f"page, the layout pinned: counts equal ({sum(c['tables'] for c in counts)} tables, "
        f"{sum(c['cells'] for c in counts)} cells, {sum(c['words'] for c in counts)} words), "
        f"quads within {d_quad} px, boxes within {d_box} px (limit 1), strings equal on equal "
        f"quads; the cell detector's sorted scores on {crops} crops within {d_score:.2e} "
        "(limit 1e-4)")
    del tsp32
    torch.cuda.empty_cache()
    return dict(max_quad_px=d_quad, max_box_px=d_box, max_d_cell_score=d_score,
                crops=crops, counts=counts)


def _phase_dp(card, ctx):
    import cv2
    import torch

    from yomitoku_tpu_torch.data.dataset import ParseqDataset
    from yomitoku_tpu_torch.data.functions import shortest_edge_size
    from yomitoku_tpu_torch.parallel import dp_mesh

    t_phase = time.perf_counter()
    numbers, paths = {}, {}
    sample = cv2.imread(str(ROOT / "demo" / "sample_text.png"))
    table = cv2.imread(str(ROOT / "demo" / "sample_table.png"))
    da = ctx.get("document_analyzer")
    if da is None:
        da = ctx["document_analyzer"] = prepared_analyzer(table)
    if "page" not in ctx:
        ctx["page"], ctx["quads"] = synthetic_lines_page()
    n_cards = torch.cuda.device_count()
    mesh = dp_mesh(2)
    check((mesh is None) == (n_cards < 2), f"dp: dp_mesh(2) on {n_cards} card(s): {mesh}")
    log(f"dp: dp_mesh(2) on {n_cards} card(s): {mesh} ("
        + ("num_devices=2 takes the page axis without a mesh: chunks of YOMITOKU_TPU_DP_CHUNK "
           "pages on the one card" if mesh is None else "one replica per card") + ")")
    det_cfg = da.text_detector._cfg.data

    def det_hw(img):
        return shortest_edge_size(*img.shape[:2], det_cfg.shortest_size, det_cfg.limit_size)

    pages = document_pages(ctx, sample, table)
    names, imgs = list(pages), list(pages.values())
    tsr = da.layout.table_structure_recognizer
    paths["document_dp"], numbers["document"] = _dp_part(
        "document_dp", da, imgs, names, det_hw, da.layout.layout_parser, tsr,
        DOCUMENT_KERNELS, card)
    paths["document_dp_host"], numbers["document_host"] = _dp_host_part(
        da, imgs, "document_dp_host", card)
    prog = da._ensure_fused_program()
    sizes = (det_hw(table), tuple(da.layout.layout_parser._cfg.data.img_size),
             tuple(tsr._cfg.data.img_size))
    numbers["document"]["batch_program"] = check_batch_program(
        prog, [table, sample, table, sample], sizes, da._workers, da.text_detector, "document_dp")

    lines = ParseqDataset(da.text_recognizer._cfg, ctx["page"], ctx["quads"][:128]).as_u8_array()
    numbers["replicas"] = check_replicas(da, [table, sample], lines, "dp")
    numbers["f32"] = check_f32_chunk(
        da, [table[:400], table[400:800], table[800:1200], sample[:400]], "dp")

    tsp = ctx.get("semantic_parser")
    if tsp is None:
        tsp = ctx["semantic_parser"] = prepared_semantic_parser(da)
    spages = {"sample_table": table, "sample_text": sample,
              "sample_table_top": table[: table.shape[0] // 2],
              "sample_text_top": sample[: sample.shape[0] // 2]}
    paths["semantic_dp"], numbers["semantic"] = _dp_part(
        "semantic_dp", tsp, list(spages.values()), list(spages), det_hw, tsp.layout_parser,
        tsp.cell_detector, SEMANTIC_KERNELS, card)
    numbers["semantic_f32"] = check_f32_semantic_chunk(
        tsp, [table[:400], table[400:800], table[800:1200], sample[:400]], "semantic_dp")
    took = numbers["phase_s"] = time.perf_counter() - t_phase
    log(f"dp: phase 12 took {took:.1f} s")
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "dp.json").write_text(json.dumps(numbers, indent=1))
    return paths, numbers


# ----------------------------------------------------------------- phase 13

#: parseq: D 512, MLP hidden 2048, 8 heads of 64, 7,310 classes
TP_D, TP_HIDDEN, TP_CLASSES, TP_TOKENS = 512, 2048, 7310, 7312
#: the tensor-parallel meshes on the one card: label -> (device list, tp):
#: (1, 2) and (2, 2) split the head and the embedding; at (1, 4) the head
#: stays whole (7,310 % 4 = 2) and the embedding splits in four
TP_MESHES = {"1x2": (["cuda:0"] * 2, 2), "2x2": (["cuda:0"] * 4, 2),
             "1x4": (["cuda:0"] * 4, 4)}
#: the meshes timed beside the unsharded model
TP_TIMED = ("1x2", "2x2")


def phase_tp(card, ctx):
    """Phase 13 with the full memory-K/V cache on every side of every
    comparison -> ({"recognizer_tp": launches}, numbers, {kernel: numbers
    at D 512})."""
    with _env(YOMITOKU_TPU_INT8_KV="0", YOMITOKU_TPU_INT8_ENCODER=None,
              YOMITOKU_TPU_HOST_CROPS="1"):
        return _phase_tp(card, ctx)


def tp_rows_placed(sm, model, what):
    """The rows of a sharded PARSeq as the rule places them: each split
    matrix in tp shards of the rule's shapes on the row's devices (the
    head whole on the lead where tp does not divide its 7,310 classes),
    every shard with storage of its own -> {"head": shapes, "embedding":
    shapes} of the first row."""
    import torch

    from yomitoku_tpu_torch.parallel.tensor_parallel import SplitEmbedding, SplitLinear

    tp = sm.mesh.shape["tp"]
    seen = {p.data_ptr() for p in model.parameters()}
    for row, devices in zip(sm.rows, sm.mesh.devices):
        emb = row.text_embed.embedding
        check(isinstance(emb, SplitEmbedding)
              and [tuple(w.shape) for w in emb.weights] == [(TP_TOKENS // tp, TP_D)] * tp
              and [w.device for w in emb.weights] == list(devices),
              f"{what}: the embedding is not in {tp} shards of {TP_TOKENS // tp} rows")
        shards = list(emb.weights)
        if TP_CLASSES % tp == 0:
            check(isinstance(row.head, SplitLinear)
                  and [tuple(w.shape) for w in row.head.weights] == [(TP_CLASSES // tp, TP_D)] * tp
                  and [tuple(b.shape) for b in row.head.biases] == [(TP_CLASSES // tp,)] * tp,
                  f"{what}: the head is not in {tp} shards of {TP_CLASSES // tp} classes")
            shards += [*row.head.weights, *row.head.biases]
        else:
            check(isinstance(row.head, torch.nn.Linear)
                  and tuple(row.head.weight.shape) == (TP_CLASSES, TP_D),
                  f"{what}: the head should stay whole at tp = {tp}")
        ptrs = [s.data_ptr() for s in shards]
        check(len(set(ptrs)) == len(ptrs) and not seen & set(ptrs),
              f"{what}: a shard shares storage with the model or another shard")
        seen |= set(ptrs)
    row = sm.rows[0]
    head = (row.head.weights if isinstance(row.head, SplitLinear) else [row.head.weight])
    return {"head": [list(w.shape) for w in head],
            "embedding": [list(w.shape) for w in row.text_embed.embedding.weights]}


def tp_captures():
    """A spy on the AR loop's graph capture -> the list of models each
    capture was made for (cleared by the caller)."""
    from yomitoku_tpu_torch.models import parseq

    made = []
    real = parseq._CachedARLoop._capture

    def counted(loop):
        made.append(loop.model)
        real(loop)

    parseq._CachedARLoop._capture = counted
    return made, lambda: setattr(parseq._CachedARLoop, "_capture", real)


def tp_sync_check(sm, x, what):
    """The first row's decode enqueued under
    torch.cuda.set_sync_debug_mode("error"): the non-AR decode with its
    refine pass (every use of the split head and embedding outside the AR
    loop), then one AR step eagerly and one replay of its graph; nothing
    may wait for the card before the readback.  The AR loop's read of its
    exit flag after each step is the one wait of a decode, as in the
    unsharded model, and stays outside the window."""
    import torch

    from yomitoku_tpu_torch.models.parseq import PARSeq

    row = sm.rows[0]
    x = x.to(row.device)
    loop = next(iter(row._ar_loops.values()))
    memory = row.encode(x[:loop.tgt_in.shape[0]])
    torch.cuda.synchronize()
    row.decode_ar = False
    torch.cuda.set_sync_debug_mode("error")
    try:
        ids, _ = PARSeq._tokens(row, x)
        loop._reset(memory)
        loop.step()
        loop.graph.replay()
    except RuntimeError as e:
        raise SmokeFailure(f"{what}: the tensor-parallel row waited for the card before "
                           f"its readback: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode(0)
        row.decode_ar = sm.model.decode_ar
    check(ids.shape[0] == x.shape[0] and bool((ids.cpu() >= 0).all()),
          f"{what}: the non-AR decode's ids are off")


def bf16_ulp(v):
    """The spacing of bf16 values at |v| (8 significant bits)."""
    import torch

    tiny = torch.finfo(torch.bfloat16).tiny
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(tiny))) - 7)


def tp_head_rounding(whole, split, what):
    """The split head against the whole one on the same bf16 input, the
    refine's 128 x 101 rows of decoder output.  cuBLAS picks its kernel by
    N, so the two sum each logit's K + 1 f32 terms in other orders and
    round the sums to bf16 apart: each logit within one bf16 ulp of the
    larger of the two, plus twice the worst-case f32 error of a sum of
    K + 1 terms in any order (K 2^-24 of the sum of their magnitudes) ->
    numbers."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(17)
    xh = torch.randn(128, STEPS, TP_D, device="cuda", generator=g).to(whole.weight.dtype)
    with torch.no_grad():
        a, b = whole(xh).float(), split(xh).float()
        mags = xh.float().abs() @ whole.weight.float().abs().t() + whole.bias.float().abs()
    reorder = 2 * TP_D * 2.0 ** -24 * mags
    d = (a - b).abs()
    excess = (d - bf16_ulp(torch.maximum(a.abs(), b.abs())) - reorder).max().item()
    ulps = (d / bf16_ulp(torch.maximum(a.abs(), b.abs()))).max().item()
    moved = float((d > 0).float().mean())
    check(excess <= 0, f"{what}: the split head's logits part from the whole head's by "
          f"{excess:.3e} more than one bf16 ulp and the f32 reordering bound")
    log(f"{what}: split head against whole on {tuple(xh.shape)} bf16: {moved:.2e} of logits "
        f"apart, at most {ulps:.2f} bf16 ulps of their own value, none past one ulp plus "
        f"the f32 reordering bound")
    return dict(share_apart=moved, max_ulps=ulps)


def parted_before_close(ids, ref, close):
    """Greedy decodes ``ids`` against ``ref`` (lines x steps) and the steps
    whose reference decision is ``close`` (one the rounding may flip) ->
    (the lines whose ids part from ``ref`` before their first close step,
    each line's first close step, or the step count where none is)."""
    import numpy as np
    import torch

    first = torch.where(close.any(-1), close.int().argmax(-1),
                        torch.full((len(ref),), ref.shape[1])).numpy()
    bad = [i for i in range(len(ref)) if not np.array_equal(ids[i, :first[i]], ref[i, :first[i]])]
    return bad, first


def tp_ar_prefix(model, sm, crops, logits, what):
    """With the refine pass off on both sides, the sharded rows' AR ids
    against the unsharded model's AR logits (``logits``, the same slices):
    on every line the ids equal up to the first step whose top-2 gap is at
    most two bf16 ulps of its top logit (one ulp each way closes it; from
    there the steps may part) -> numbers."""
    import numpy as np

    model.refine_iters = 0
    try:
        ids, _ = sm.forward_tokens(crops)
    finally:
        model.refine_iters = 1
    top2 = logits.topk(2, dim=-1).values
    ref = logits.argmax(-1).numpy()
    n_steps = ref.shape[1]
    bad, first = parted_before_close(
        ids, ref, (top2[..., 0] - top2[..., 1]) <= 2 * bf16_ulp(top2[..., 0]))
    check(not bad, f"{what}: the AR ids part from the unsharded model's before a closable "
          f"step on lines {bad[:8]}")
    whole = int((ids == ref).all(-1).sum())
    log(f"{what}: refine off, AR ids equal to the unsharded model's on every line up to its "
        f"first step with a top-2 gap within two bf16 ulps (median step "
        f"{int(np.median(first))} of {n_steps}); {whole} of {len(ref)} lines equal throughout")
    return dict(lines_equal=whole, lines=len(ref), first_closable_median=int(np.median(first)))


def _phase_tp(card, ctx):
    import numpy as np
    import torch
    import torch.nn.functional as F

    from yomitoku_tpu_torch import ops
    from yomitoku_tpu_torch.data.dataset import ParseqDataset
    from yomitoku_tpu_torch.models.parseq import PARSeq
    from yomitoku_tpu_torch.parallel import make_mesh, parseq_param_shardings, shard_params
    from yomitoku_tpu_torch.text_recognizer import TextRecognizer

    t_phase = time.perf_counter()
    numbers = {"card": card}
    # 1. kernels 1-4 at parseq's width against their plain versions, timed
    kernels = phase_kernels(D=TP_D, hidden=TP_HIDDEN, tag="_d512", layouts=LAYOUTS[:1],
                            seed=13)

    # 2. the unsharded recognizer on the synthetic page: parseq's first card run
    if "page" not in ctx:
        ctx["page"], ctx["quads"] = synthetic_lines_page()
    page, quads = ctx["page"], ctx["quads"]
    rec = TextRecognizer(model_name="parseq", device="cuda")
    model = rec.model
    check(model.head.out_features == TP_CLASSES and model.head.in_features == TP_D
          and model.num_tokens == TP_TOKENS and not model.int8_kv,
          f"tp: parseq is not D {TP_D}, {TP_CLASSES} classes with the full K/V cache")
    lines, _ = rec(page, quads)
    _finite_schema(lines, "tp: recognizer")
    check(len(lines.contents) == len(quads),
          f"tp: the recognizer returned {len(lines.contents)} of {len(quads)} lines")
    log(f"tp: TextRecognizer(model_name='parseq', device='cuda'): PARSeq "
        f"{model.param_count():,} params, {model.dtype}; {len(lines.contents)} lines of the "
        f"synthetic page, first {lines.contents[0][:20]!r}")
    crops = ParseqDataset(rec._cfg, page, quads[:128]).as_u8_array()
    x = torch.from_numpy(crops)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec32 = TextRecognizer(model_name="parseq", device="cuda", dtype=torch.float32,
                           from_pretrained=False)
    cpu32 = TextRecognizer(model_name="parseq", device="cpu", from_pretrained=False)
    got = rec32.model.forward_logits(x[:16]).cpu()
    line = f32_card_vs_cpu_logits(got, cpu32.model.forward_logits(x[:16]), "tp: f32")
    log(f"tp: f32 parseq card vs CPU on 16 lines: {line}")
    del cpu32, got

    # 3. the tp rows against the unsharded model on the same 128 lines, in
    # the same slices (a row of a (2, 2) mesh decodes 64 of them, and the
    # kernels' routes, and so their rounding, follow the batch size)
    refs = {}

    def reference(dp, refine_iters=1):
        """The unsharded bf16 model on the lines in dp slices -> its (ids,
        probs, near-ties: top-2 gap < 1e-4) and the f32 model's (ids,
        probs); with ``refine_iters`` 0 the bf16 model's AR logits."""
        key = (dp, refine_iters)
        if key not in refs:
            n = len(crops) // dp
            cut = [slice(s, s + n) for s in range(0, len(crops), n)]
            if refine_iters:
                bf = []
                with torch.no_grad():
                    for c in cut:
                        logits = model.forward_logits(x[c])
                        top2 = logits.topk(2, dim=-1).values
                        bf.append([t.cpu().numpy() for t in PARSeq._tokens_of(logits)]
                                  + [((top2[..., 0] - top2[..., 1]) < 1e-4).cpu().numpy()])
                f32 = [rec32.model.forward_tokens(crops[c]) for c in cut]
                refs[key] = tuple(np.concatenate([o[i] for o in outs])
                                  for outs, k in ((bf, 3), (f32, 2)) for i in range(k))
            else:
                model.refine_iters = 0
                try:
                    with torch.no_grad():
                        refs[key] = torch.cat([model.forward_logits(x[c]).cpu() for c in cut])
                finally:
                    model.refine_iters = 1
        return refs[key]

    meshes = {lb: make_mesh(devices=devs, tp=tp) for lb, (devs, tp) in TP_MESHES.items()}
    for m in meshes.values():
        reference(m.shape["dp"])
    sharded = {lb: shard_params(model, parseq_param_shardings(model, m))
               for lb, m in meshes.items()}
    for lb, sm in sharded.items():
        numbers.setdefault("meshes", {})[lb] = dict(
            shape=dict(sm.mesh.shape), shards=tp_rows_placed(sm, model, f"tp {lb}"))
    made, restore = tp_captures()
    try:
        # the slice's main path, counted: each mesh's rows decode the 128
        # lines (the first batch of a shape captures each row's AR graph)
        ops.reset_launches()
        outs = {lb: sm.forward_tokens(crops) for lb, sm in sharded.items()}
        torch.cuda.synchronize()
        launches = dict(ops.launches)
        log(f"recognizer_tp: launches {launches}")
        check(all(launches[k] > 0 for k in OCR_KERNELS),
              f"recognizer_tp: a kernel of the path was never launched: {launches}")
        check_attention_routes("recognizer_tp")
        check_gemm_routes("recognizer_tp")
        rows = [r for sm in sharded.values() for r in sm.rows]
        check(sorted(map(id, made)) == sorted(map(id, rows)),
              f"tp: {len(made)} AR graphs captured for {len(rows)} rows, one each expected")
        for lb, sm in sharded.items():
            for row in sm.rows:
                loops = list(row._ar_loops.values())
                check(len(loops) == 1 and loops[0].capturable and loops[0].graph is not None,
                      f"tp {lb}: a row holds {len(loops)} AR loops, one with its graph expected")
            ref_ids, ref_probs, tie = reference(sm.mesh.shape["dp"])[:3]
            ids, probs = outs[lb]
            check(ids.shape == ref_ids.shape and np.isfinite(probs).all(),
                  f"tp {lb}: bf16 tokens of shape {ids.shape}, not finite or not the lines'")
            same = int((ids == ref_ids).sum())
            check(not ((ids != ref_ids) & ~tie).any(),
                  f"tp {lb}: bf16 ids differ from the unsharded model's at "
                  f"{int(((ids != ref_ids) & ~tie).sum())} positions with a top-2 gap >= 1e-4")
            numbers["meshes"][lb].update(bf16_ids_equal=same, positions=ids.size,
                                         near_ties=int(tie.sum()))
            if TP_CLASSES % sm.mesh.shape["tp"]:
                # the head whole, the embedding's lookups bit-equal: the
                # same bits as the unsharded model
                check(np.array_equal(ids, ref_ids) and np.array_equal(probs, ref_probs),
                      f"tp {lb}: with the head whole the bf16 tokens are not bit-equal to the "
                      "unsharded model's")
            log(f"tp {lb} mesh {dict(sm.mesh.shape)}: shards {numbers['meshes'][lb]['shards']}; "
                f"bf16 ids equal to the unsharded model's at {same}/{ids.size} positions "
                f"({int(tie.sum())} near-tie positions, top-2 gap < 1e-4, exempt)"
                + (" (bit-equal, probs too)" if TP_CLASSES % sm.mesh.shape["tp"] else "")
                + "; one AR graph captured per row")
        # a second batch replays each row's graph
        again = {lb: sm.forward_tokens(crops) for lb, sm in sharded.items()}
        check(all(np.array_equal(again[lb][0], outs[lb][0]) for lb in sharded),
              "tp: a replayed decode differs from the capturing one")
        made.clear()
        # f32: ids equal, probs within 1e-5
        for lb, m in meshes.items():
            sm32 = shard_params(rec32.model, parseq_param_shardings(rec32.model, m))
            ids, probs = sm32.forward_tokens(crops)
            ref32 = reference(m.shape["dp"])[3:]
            dp = float(np.abs(probs - ref32[1]).max())
            check(np.array_equal(ids, ref32[0]) and dp <= 1e-5,
                  f"tp {lb}: f32 ids differ at {int((ids != ref32[0]).sum())} positions or "
                  f"probs by {dp:.3e} > 1e-5 from the unsharded model's")
            numbers["meshes"][lb]["f32_max_d_prob"] = dp
            log(f"tp {lb}: f32 ids equal to the unsharded model's on 128 lines, max|d prob| "
                f"{dp:.3e} (limit 1e-5)")
            del sm32
    finally:
        restore()
    # bf16 with the head split: its GEMM on 3,655 columns rounds apart from
    # the whole one's by at most one bf16 ulp; the AR decode then follows
    # the unsharded one until a step whose top-2 gap that rounding can close
    row = sharded["1x2"].rows[0]
    numbers["head_rounding"] = tp_head_rounding(model.head, row.head, "tp 1x2")
    for lb, sm in sharded.items():
        if TP_CLASSES % sm.mesh.shape["tp"] == 0:
            numbers["meshes"][lb]["ar_prefix"] = tp_ar_prefix(
                model, sm, crops, reference(sm.mesh.shape["dp"], refine_iters=0), f"tp {lb}")
    tp_sync_check(sharded["1x2"], x, "tp 1x2")
    log("tp 1x2: the non-AR decode and refine, one AR step and one replay of its graph "
        "enqueued with torch.cuda.set_sync_debug_mode('error'): no wait for the card "
        "before the readback")

    # the head's GEMM split in two (each shard padded to 3,656 columns)
    # against whole (device time), at the AR step's 128 rows and the
    # refine's 128 x 101; and one shard unpadded, whose 3,655-column output
    # rows (7,310 bytes) are not 16-byte aligned
    row = sharded["1x2"].rows[0]
    head_ms = {}
    for label, m_rows in (("step", 1), ("refine", STEPS)):
        xh = torch.randn(128, m_rows, TP_D, device="cuda", dtype=model.dtype)
        with torch.no_grad():
            whole = loop_ms(lambda: model.head(xh))
            split = loop_ms(lambda: row.head(xh))
            padded = loop_ms(lambda: F.linear(xh, *row.head.gemms[0][:2]))
            unpadded = loop_ms(lambda: F.linear(xh, row.head.weights[0], row.head.biases[0]))
        head_ms[label] = dict(whole_ms=whole, split_ms=split, padded_shard_ms=padded,
                              unpadded_shard_ms=unpadded)
        log(f"tp: head GEMM at ({128 * m_rows}, {TP_D}) -> {TP_CLASSES} bf16 [{label}] (CUDA "
            f"events over 50 calls, median of 5): whole {_ms(whole)}, split in two "
            f"{_ms(split)}; one shard padded to "
            f"{row.head.gemms[0][0].shape[0]} columns {_ms(padded)}, unpadded "
            f"({TP_CLASSES // 2} columns, rows of {TP_CLASSES // 2 * 2} bytes) {_ms(unpadded)}; "
            f"card {card}")
    numbers["head_gemm"] = head_ms

    # lines/s: the unsharded model beside (1, 2) and (2, 2), in turns
    fns = {"unsharded": lambda: model.forward_tokens(crops),
           **{lb: (lambda sm=sharded[lb]: sm.forward_tokens(crops)) for lb in TP_TIMED}}
    times = interleaved(fns, runs=5)
    numbers["lines_per_s"] = {k: 128 / v for k, v in times.items()}
    numbers["ms_per_batch"] = {k: v * 1e3 for k, v in times.items()}
    log("tp: bf16 batch of 128 lines end to end (median of 5, in turns): " + ", ".join(
        f"{k} {128 / v:.1f} lines/s ({v * 1e3:.1f} ms)" for k, v in times.items())
        + f"; card {card}")
    took = numbers["phase_s"] = time.perf_counter() - t_phase
    log(f"tp: phase 13 took {took:.1f} s")
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "tp.json").write_text(json.dumps(numbers, indent=1))
    del rec, rec32, sharded, model
    torch.cuda.empty_cache()
    return {"recognizer_tp": launches}, numbers, kernels


# ----------------------------------------------------------------- phase 14

#: yomitoku_torch --lite (parseq-tiny, dbnetv2_1-lite) and parseq-small:
#: recognizer -> (D, MLP hidden, tokens per line, refine queries), 8 heads
#: each (46 and 48 wide), batch 128
LITE_RECOGNIZERS = {"parseq-tiny": (368, 1472, 100, 51), "parseq-small": (384, 1536, 100, 101)}
#: the kernels held and timed at each recognizer's shapes, and their label
LITE_KERNELS = {"parseq-tiny": ("tiny", OCR_KERNELS),
                "parseq-small": ("small", ("fused_attention_block_ln", "fused_attention_heads"))}
#: kernels 6 and 7 at parseq-tiny's head dim of 46: fused_attention's (B,
#: H, L, Dh) and fused_attention_block's x (B, L, D), 8 heads
DH46_ATTENTION = ((128, 8, 100, 46), (8, 100, 368))
#: the OCR modules' models of the CLI's --lite
LITE_MODEL_NAMES = {"text_detector": "dbnetv2_1-lite", "text_recognizer": "parseq-tiny"}


def phase_lite(card, ctx):
    """Phase 14 with the full memory-K/V cache (the f32 checks compare
    with it) -> ({path: launches}, numbers, {kernel: {label: numbers}})."""
    with _env(YOMITOKU_TPU_INT8_KV="0", YOMITOKU_TPU_INT8_ENCODER=None,
              YOMITOKU_TPU_HOST_CROPS=None, YOMITOKU_TPU_DEVICE_CROPS=None,
              YOMITOKU_TPU_REC_WIDTH_BUCKETS=None):
        return _phase_lite(card, ctx)


def sentinel_edge(D_, steps):
    """The attention kernel writing its output into the first D_ columns of
    wider rows (D_ + 8) holding a sentinel, at a refine's q (128, steps,
    D_) over k, v (128, 100, D_), 8 heads: the sentinel survives and the
    output holds to the plain version (2e-2 of the largest value) ->
    max|d|."""
    import torch

    from yomitoku_tpu_torch import ops
    from yomitoku_tpu_torch.ops._common import attention

    gen = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn(B, steps, D_, device="cuda", generator=gen).bfloat16()
    k, v = (torch.randn(B, 100, D_, device="cuda", generator=gen).bfloat16() for _ in range(2))
    buf = torch.full((B, steps, D_ + 8), 7.0, dtype=torch.bfloat16, device="cuda")
    route = route_taken(lambda: attention(q, k, v, buf[..., :D_], HEADS, (D_ // HEADS) ** -0.5))
    want = ops.fused_attention_heads_reference(q.float(), k.float(), v.float(), HEADS)
    err = (buf[..., :D_].float() - want).abs().max().item()
    kept = bool((buf[..., D_:] == 7.0).all().item())
    log(f"attention into a wider buffer (rows of {D_ + 8}, the output its first {D_} columns), "
        f"q {tuple(q.shape)}: route {route}, max|d| {err:.3e} (limit "
        f"{2e-2 * want.abs().max().item():.3e}), sentinel columns kept: {kept}")
    check(kept and err <= 2e-2 * want.abs().max().item() and route in ("wgmma", "wgmma_small"),
          f"attention into a wider buffer at D {D_}: sentinel kept {kept}, max|d| {err:.3e}, "
          f"route {route}")
    return err


def lite_recognizer(name, page, quads, card):
    """``TextRecognizer(model_name=name, device="cuda")`` (seed-0 weights,
    bf16, the device-page route) on the synthetic page, counted; its
    lines/s and decode; in f32 on the card against the CPU on 16 lines
    (phase 3's gate) and bf16 against f32 on the card (bf16_vs_f32_prefix)
    -> (launches, numbers)."""
    import torch

    from yomitoku_tpu_torch import ops
    from yomitoku_tpu_torch.data.dataset import ParseqDataset
    from yomitoku_tpu_torch.text_recognizer import TextRecognizer

    D_, _, tokens, steps = LITE_RECOGNIZERS[name]
    what = f"lite: {name}"
    t0 = time.perf_counter()
    rec = TextRecognizer(model_name=name, device="cuda")
    model = rec.model
    check(model.head.in_features == D_ and math.prod(model.encoder.grid) == tokens
          and model.max_label_length + 1 == steps and not model.int8_kv,
          f"{what}: not D {D_}, {tokens} tokens, {steps} positions with the full K/V cache")
    log(f"{what}: TextRecognizer(model_name={name!r}, device='cuda') built in "
        f"{time.perf_counter() - t0:.1f} s: PARSeq {model.param_count():,} params, "
        f"{model.dtype}, canvas {model.img_size}, {tokens} tokens, {steps} positions")
    ops.reset_launches()
    lines, _ = rec(page, quads)
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    log(f"{what}: launches {launches}")
    check(all(launches[k] > 0 for k in OCR_KERNELS),
          f"{what}: a kernel of the path was never launched: {launches}")
    check_attention_routes(what, "wgmma")
    check_gemm_routes(what)
    _finite_schema(lines, what)
    check(len(lines.contents) == len(quads),
          f"{what}: {len(lines.contents)} of {len(quads)} lines")
    crops = ParseqDataset(rec._cfg, page, quads[:128]).as_u8_array()
    x = torch.from_numpy(crops)
    numbers = {}
    rec_s = host_timed(lambda: rec(page, quads[:128]))
    decode_s = host_timed(lambda: model.forward_tokens(crops))
    busy, attn, gemm_ms, _ = decode_profile(model, crops)
    numbers.update(lines_per_s=128 / rec_s, decode_lines_per_s=128 / decode_s,
                   ms_per_batch=rec_s * 1e3, decode_ms=decode_s * 1e3, device_busy_ms=busy,
                   attention_ms=attn, gemm_ms=gemm_ms)
    log(f"{what}: bf16 batch 128 on the page route {128 / rec_s:.1f} lines/s end to end "
        f"({rec_s * 1e3:.1f} ms), decode {128 / decode_s:.1f} lines/s "
        f"({decode_s * 1e3:.1f} ms), device busy {busy:.2f} ms of which the attention kernel "
        f"{attn:.3f} ms and the GEMM kernel with its LayerNorm pass {gemm_ms:.3f} ms; "
        f"median of 3; card {card}")
    check_attention_routes(what + " (timed runs)", "wgmma")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec32 = TextRecognizer(model_name=name, device="cuda", dtype=torch.float32,
                           from_pretrained=False)
    cpu32 = TextRecognizer(model_name=name, device="cpu", from_pretrained=False)
    with torch.no_grad():
        got = rec32.model.forward_logits(x[:16]).cpu()
    line = f32_card_vs_cpu_logits(got, cpu32.model.forward_logits(x[:16]), f"{what} f32")
    log(f"{what}: f32 card vs CPU on 16 lines: {line}")
    numbers.update(f32_card_vs_cpu=line,
                   bf16_vs_f32=bf16_vs_f32_prefix(model, rec32.model, x, what))
    if name == "parseq-tiny":
        numbers["width_bucket"] = lite_width_bucket(rec, what)
    del rec, rec32, cpu32, model
    torch.cuda.empty_cache()
    return launches, numbers


def lite_width_bucket(rec, what):
    """The recognizer's half-width bucket forced (parseq-tiny: 192 px, 48
    tokens of its (8, 16) patches): on a page of 128 short lines and 8 long
    ones, the lines that fit decode at the narrow canvas, their strings
    equal to the model's at out_w=192 called directly, and the AR loop
    keeps a state for the 48-token memory beside the 100-token one ->
    numbers."""
    import unicodedata

    import numpy as np
    import torch

    from yomitoku_tpu_torch import ops
    from yomitoku_tpu_torch.ops import device_crop as dc

    model = rec.model
    (bucket,) = rec._default_width_buckets()
    tokens = (model.img_size[0] // 8) * (bucket // 16)
    page, quads = synthetic_lines_page(136, seed=1, chars=[(3, 8)] * 128 + [(30, 40)] * 8)
    mats, wh = dc.line_homographies(quads, model.img_size)
    fits = np.flatnonzero(wh[:, 0] <= bucket)
    check(len(fits) >= 64 and len(fits) < len(quads),
          f"{what}: {len(fits)} of the bucket page's {len(quads)} lines fit {bucket} px")
    with _env(YOMITOKU_TPU_REC_WIDTH_BUCKETS=str(bucket)):
        check(rec._width_buckets() == [bucket], f"{what}: the forced bucket")
        ops.reset_launches()
        routed = rec._call_device(page, quads)
        torch.cuda.synchronize()
    check_attention_routes(f"{what} width bucket")
    ids, probs = model.forward_tokens_from_page(dc.DevicePage(page, "cuda").dev, mats[fits],
                                                wh[fits], out_w=bucket)
    want, want_s = rec.tokenizer.decode_ids(ids, probs)
    want = [unicodedata.normalize("NFKC", p) for p in want]
    got = [routed[0][i] for i in fits]
    check(got == want and np.allclose([routed[1][i] for i in fits], want_s, rtol=1e-6),
          f"{what}: the lines routed to the {bucket}-px bucket differ from the model at "
          f"out_w={bucket}")
    memories = sorted({m for _, m in model._ar_loops})
    check(tokens in memories and math.prod(model.encoder.grid) in memories,
          f"{what}: AR states for memory lengths {memories}, {tokens} and "
          f"{math.prod(model.encoder.grid)} expected")
    log(f"{what}: {bucket}-px width bucket forced: {len(fits)} lines routed narrow ({tokens} "
        f"tokens) and {len(quads) - len(fits)} full; the narrow lines' strings equal the "
        f"model's at out_w={bucket}; AR states (batch, memory) {sorted(model._ar_loops)}")
    return dict(bucket=bucket, tokens=tokens, narrow_lines=len(fits),
                ar_states=[list(k) for k in sorted(model._ar_loops)])


def bf16_vs_f32_prefix(bf, f32, x, what):
    """The bf16 model against the same weights in f32 on the card, 128
    lines, the refine pass off on both (greedy AR decodes): on every line
    the ids equal up to the first step whose f32 top-2 gap is within the
    kernels' bf16 allowance, 2e-2 of the largest f32 logit (a decision that
    bf16 rounding may flip; from there the decodes may part), and the
    logits of the first position (no token fed back) within that allowance
    -> numbers, with the share of ids equal throughout."""
    import numpy as np
    import torch

    logits = {}
    for key, m in (("bf16", bf), ("f32", f32)):
        m.refine_iters = 0
        try:
            with torch.no_grad():
                logits[key] = m.forward_logits(x).float().cpu()
        finally:
            m.refine_iters = 1
    want, got = logits["f32"], logits["bf16"]
    allowance = 2e-2 * want.abs().max().item()
    top2 = want.topk(2, dim=-1).values
    ref, ids = want.argmax(-1).numpy(), got.argmax(-1).numpy()
    n_steps = ref.shape[1]
    bad, first = parted_before_close(ids, ref, (top2[..., 0] - top2[..., 1]) <= allowance)
    d0 = (got[:, 0] - want[:, 0]).abs().max().item()
    res = dict(lines=len(ref), lines_equal=int((ids == ref).all(-1).sum()),
               ids_equal=float((ids == ref).mean()), first_close_median=int(np.median(first)),
               allowance=allowance, first_position_max_abs_logit=d0)
    log(f"{what}: bf16 against f32 on the card, {len(ref)} lines, refine off: AR ids equal on "
        f"every line up to its first step with an f32 top-2 gap within {allowance:.3e} (2e-2 "
        f"of the largest f32 logit; median step {res['first_close_median']} of {n_steps}): "
        f"{'yes' if not bad else 'no, lines ' + str(bad[:8])}; ids equal at "
        f"{res['ids_equal']:.4f} of positions, {res['lines_equal']} lines throughout; the first "
        f"position's logits max|d| {d0:.3e} (limit {allowance:.3e})")
    check(not bad and d0 <= allowance,
          f"{what}: bf16 AR ids part from f32 before a step bf16 may flip (lines {bad[:8]}), "
          f"or the first position's logits by {d0:.3e} > {allowance:.3e}")
    return res


def lite_analyzer(src):
    """``DocumentAnalyzer`` with the --lite models on the card, given
    ``src``'s (phase 9's) detector, layout and table weights (the
    recognizer keeps its seed-0 parseq-tiny), its detector painted."""
    from yomitoku_tpu_torch.document_analyzer import DocumentAnalyzer

    names = {k: {"model_name": v} for k, v in LITE_MODEL_NAMES.items()}
    da = DocumentAnalyzer(configs={"ocr": names}, device="cuda")
    same_weights(da, src, recognizer=False)
    paint_detector(da.text_detector)
    return da


def lite_cli(card, ctx):
    """``yomitoku_torch demo/sample.pdf --lite -f json`` in this process
    (cli_harness on the lite analyzer), counted; each page's JSON equal to
    convert_json of the CLI's analyzer's ``__call__``; pages/s with and
    without construction and per stage; one page's f32 lite analyzer on
    the card against the CPU -> (launches, numbers)."""
    import cv2
    import torch

    from yomitoku_tpu_torch import ops
    from yomitoku_tpu_torch.data import load_pdf
    from yomitoku_tpu_torch.export import convert_json

    src = ctx.get("document_analyzer")
    if src is None:
        src = ctx["document_analyzer"] = prepared_analyzer(
            cv2.imread(str(ROOT / "demo" / "sample_table.png")))
    lite = lite_analyzer(src)
    sample, n = CLI_PDFS["sample"]
    pages = list(load_pdf(ROOT / "demo" / sample, dpi=200))
    numbers = {}
    with cli_harness(lite) as (cli, clock):
        ops.reset_launches()
        took, spent, files = run_cli(cli, clock, "lite_json", sample, ["--lite", "-f", "json"])
        torch.cuda.synchronize()
        launches = dict(ops.launches)
        log(f"lite: path cli_lite launches {launches}")
        check(all(launches[k] > 0 for k in DOCUMENT_KERNELS),
              f"a kernel of the --lite CLI path was never launched: {launches}")
        check_attention_routes("cli_lite")
        check_gemm_routes("cli_lite")
        check_deform_routes("cli_lite", launches["ms_deformable_attention"])
        kwargs, da = clock["built"][-1]
        ocr_cfg = kwargs["configs"]["ocr"]
        check(kwargs["device"] == "cuda" and all(
            ocr_cfg[k]["model_name"] == v for k, v in LITE_MODEL_NAMES.items()),
            f"lite: the CLI built its analyzer with {kwargs}")
        check([p.name for p in files] == expected_cli_files("sample", n, "json"),
              f"lite: files {[p.name for p in files]}")
        words = []
        for i, (page, path) in enumerate(zip(pages, files), 1):
            doc = da(page)[0]
            want = convert_json(doc, None, False, page, False).model_dump()
            got = json.loads(path.read_text(encoding="utf-8"))
            check(got == want, f"lite: --lite -f json page {i} against __call__: "
                  f"{_first_difference(got, want)}")
            check(doc.words, f"lite: --lite -f json page {i}: no words")
            words.append(len(doc.words))
        log(f"lite: yomitoku_torch demo/{sample} --lite -f json: each page's JSON equals "
            f"convert_json of the analyzer's __call__ on the same rendered page ({words} "
            f"words; first run {took:.2f} s)")
        took, spent, _ = run_cli(cli, clock, "lite_json_warm", sample, ["--lite", "-f", "json"])
    other = took - spent["construct_s"] - spent["render_s"] - spent["analyze_s"]
    numbers.update(pages=n, words=words, pages_s=n / took,
                   pages_s_without_construction=n / (took - spent["construct_s"]),
                   per_page_ms=dict(construct=spent["construct_s"] * 1e3 / n,
                                    render=spent["render_s"] * 1e3 / n,
                                    analyzer=spent["analyze_s"] * 1e3 / n,
                                    export_and_rest=other * 1e3 / n))
    log(f"lite: yomitoku_torch demo/{sample} --lite -f json: {n / took:.3f} pages/s end to end "
        f"({took:.2f} s for {n} pages, the analyzer's construction included; "
        f"{numbers['pages_s_without_construction']:.3f} pages/s without it); per page: "
        f"construction {numbers['per_page_ms']['construct']:.0f} ms, PDF render "
        f"{numbers['per_page_ms']['render']:.0f} ms, analyzer (batch) "
        f"{numbers['per_page_ms']['analyzer']:.0f} ms, export and the rest "
        f"{numbers['per_page_ms']['export_and_rest']:.0f} ms; card {card}")
    del da
    table = cv2.imread(str(ROOT / "demo" / "sample_table.png"))
    numbers["f32_card_vs_cpu"] = f32_card_vs_cpu(lite, table[:400], LITE_MODEL_NAMES, "lite")
    del lite
    torch.cuda.empty_cache()
    return launches, numbers


def _phase_lite(card, ctx):
    import numpy as np
    import torch

    from yomitoku_tpu_torch import ops

    t_phase = time.perf_counter()
    numbers = {"card": card}
    # (a) the kernels at parseq-tiny's and parseq-small's shapes
    kernels = {}
    for name, (D_, hidden, tokens, steps) in LITE_RECOGNIZERS.items():
        label, names = LITE_KERNELS[name]
        shaped = phase_kernels(D=D_, hidden=hidden, tag=f"_{label}", layouts=LAYOUTS[:1],
                               seed=14, L=tokens, steps=steps, names=names, fma=True)
        for k, at in shaped.items():
            kernels.setdefault(k, {})[label] = at
        kernels["fused_attention_heads"][label]["sentinel_max_abs_err"] = sentinel_edge(
            D_, steps)
    # 6 and 7 at head dim 46 (fused_attention on head-packed copies: rows
    # of 92 bytes are no TMA rows), 8 at tiny's encoder shape
    for k, at in _attention_kernels(np.random.default_rng(46), *DH46_ATTENTION,
                                    labels=("dh46", "dh46")).items():
        kernels.setdefault(k, {}).update(at)
    D_, _, tokens, _ = LITE_RECOGNIZERS["parseq-tiny"]
    for k, at in phase_int8_kernels(46, tokens, D_, ("fused_attention_block_ln_int8",),
                                    codes_rule=True).items():
        kernels.setdefault(k, {})["dh46"] = at
    ops.reset_launches()

    # (b) the recognizers at batch 128 on the synthetic page
    if "page" not in ctx:
        ctx["page"], ctx["quads"] = synthetic_lines_page()
    paths = {}
    for name in LITE_RECOGNIZERS:
        label = LITE_KERNELS[name][0]
        paths[f"recognizer_{label}"], numbers[name] = lite_recognizer(
            name, ctx["page"], ctx["quads"], card)

    # (c) the CLI with --lite
    paths["cli_lite"], numbers["cli"] = lite_cli(card, ctx)
    took = numbers["phase_s"] = time.perf_counter() - t_phase
    log(f"lite: phase 14 took {took:.1f} s")
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "lite.json").write_text(json.dumps({"numbers": numbers, "kernels": kernels},
                                              indent=1, default=str))
    torch.cuda.empty_cache()
    return paths, numbers, kernels


def lite_only(root):
    """``--lite``: phase 14 (yomitoku_torch --lite and parseq-small) alone,
    with phase 9's analyzer setup, on this checkout's package."""
    from yomitoku_tpu_torch.ops import _build

    if root != ROOT:
        raise SmokeFailure("--lite runs on this checkout only")
    card = card_line()
    log(f"card: {card}")
    t0 = time.perf_counter()
    _build.library()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    paths, numbers, kernels = phase_lite(card, {})
    log(card)
    print(json.dumps({"launches_by_path": paths, "lite": numbers, "kernels": kernels},
                     default=str), flush=True)
    return 0


def tp_only(root):
    """``--tp``: phase 13 (PARSeq with its vocabulary split over tp) alone,
    on this checkout's package."""
    from yomitoku_tpu_torch.ops import _build

    if root != ROOT:
        raise SmokeFailure("--tp runs on this checkout only")
    card = card_line()
    log(f"card: {card}")
    t0 = time.perf_counter()
    _build.library()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    paths, numbers, kernels = phase_tp(card, {})
    log(card)
    print(json.dumps({"launches_by_path": paths, "tp": numbers, "d512": kernels}), flush=True)
    return 0


def dp_only(root):
    """``--dp``: phase 12 (the page axis) alone, with phase 9's analyzer
    setup, on this checkout's package."""
    from yomitoku_tpu_torch.ops import _build

    if root != ROOT:
        raise SmokeFailure("--dp runs on this checkout only")
    card = card_line()
    log(f"card: {card}")
    t0 = time.perf_counter()
    _build.library()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    paths, numbers = phase_dp(card, {})
    log(card)
    print(json.dumps({"launches_by_path": paths, "dp": numbers}), flush=True)
    return 0

def fused_kernels_only(root):
    """``--fused-kernels [ROOT]``: kernels 10 and 11 at their eleven shapes
    (against their plain versions, then timed against the unfused cuDNN
    chain) and the fused DBNet forward's device busy with its
    csrc/bottleneck.cu share, run on the package at ROOT: this checkout's,
    or another commit's unpacked beside it, to compare the two on one card
    (the per-convolution lines only for this checkout's)."""
    import cv2
    import torch

    from yomitoku_tpu_torch.ops import _build
    from yomitoku_tpu_torch.text_detector import TextDetector

    card = card_line()
    log(f"card: {card}")
    log(f"package: {root}")
    t0 = time.perf_counter()
    _build.library()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    shaped = phase_fused_kernels(convs=root == ROOT, attention=False)
    det = TextDetector(device="cuda")  # dbnetv2_1, seed-0 weights, bf16
    u8 = torch.from_numpy(det.preprocess_u8(cv2.imread(str(ROOT / "demo" / "sample_text.png"))))
    with _env(YOMITOKU_TPU_FUSED_BOTTLENECK="1", YOMITOKU_TPU_FUSED_STAGE="1"):
        wall, device, _, _ = profiled(lambda: det.model.forward_u8(u8), runs=5)
    busy, share = sum(device.values()), bottleneck_share(device)
    log(f"fused: dbnet_forward csrc/bottleneck.cu kernels {share:.3f} ms of {busy:.3f} ms "
        f"device busy ({100 * share / busy:.1f}%), {wall:.2f} ms wall")
    log(card)
    print(json.dumps({"package": str(root), "device_ms": {
        name: {label: r["device_ms"] for label, r in at.items()} for name, at in shaped.items()},
        "dbnet_forward": {"device_busy_ms": busy, "bottleneck_kernels_ms": share}}), flush=True)
    return 0


def deform_kernels_only(root):
    """``--deform-kernels [ROOT]``: phase 2's ms_deformable_attention lines
    alone, at its four shapes (lq300, b4_lq300, lq2500, b4_lq2500), on the package at
    ROOT: this checkout's, or another commit's unpacked beside it, to
    compare the two on one card in turns (the route and scalar-route lines
    only for this checkout's)."""
    from yomitoku_tpu_torch.ops import _build

    card = card_line()
    log(f"card: {card}")
    log(f"package: {root}")
    t0 = time.perf_counter()
    _build.library()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    name = "ms_deformable_attention"
    at = phase_layout_kernels((name,), own=root == ROOT)[name]
    log(card)
    print(json.dumps({"package": str(root), "deform": at}), flush=True)
    return 0


def attention_kernels_only(root):
    """``--attention-kernels [ROOT]``: the attention kernel's main-path
    rows at their shapes: kernels 1 and 3 at the recognizer's (phase 2,
    one layout), 3 at RT-DETR's eight (AIFI, decoder, the cell decoder's
    2,500 queries, their batches), 6 and 7 at the ViT's and the AIFI's
    (phase 7), each against its plain version and timed, on the package at
    ROOT: this checkout's, or another commit's unpacked beside it, to
    compare the two on one card in turns."""
    import numpy as np

    from yomitoku_tpu_torch.ops import _build

    card = card_line()
    log(f"card: {card}")
    log(f"package: {root}")
    t0 = time.perf_counter()
    _build.library()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    shaped = {name: {"parseq": res} for name, res in phase_kernels(
        layouts=LAYOUTS[:1], names=("fused_attention_block_ln", "fused_attention_heads")).items()}
    for name, at in phase_layout_kernels(("fused_attention_heads",), own=root == ROOT).items():
        shaped[name].update(at)
    shaped.update(_attention_kernels(np.random.default_rng(7)))
    log(card)
    print(json.dumps({"package": str(root), "device_ms": {
        name: {label: r["device_ms"] for label, r in at.items()} for name, at in shaped.items()},
        "ms": {name: {label: r["ms"] for label, r in at.items()} for name, at in shaped.items()}}),
        flush=True)
    return 0


def page_only(root):
    """``--page``: phase 8 (the device-page route) alone, on this checkout's
    package, with the synthetic 136-line page of phase 3."""
    from yomitoku_tpu_torch.ops import _build

    if root != ROOT:
        raise SmokeFailure("--page runs on this checkout only")
    card = card_line()
    log(f"card: {card}")
    t0 = time.perf_counter()
    _build.library()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    page, quads = synthetic_lines_page()
    paths, numbers = phase_page(card, dict(page=page, quads=quads))
    log(card)
    print(json.dumps({"launches_by_path": paths, "page": numbers}), flush=True)
    return 0


def cli_only(root):
    """``--cli``: phase 9's analyzer setup (prepared_analyzer), then phase
    10 (the CLI backend on demo/sample.pdf), on this checkout's package."""
    from yomitoku_tpu_torch.ops import _build

    if root != ROOT:
        raise SmokeFailure("--cli runs on this checkout only")
    card = card_line()
    log(f"card: {card}")
    t0 = time.perf_counter()
    _build.library()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    with _env(YOMITOKU_TPU_INT8_KV=None, YOMITOKU_TPU_INT8_ENCODER=None,
              YOMITOKU_TPU_HOST_CROPS=None, YOMITOKU_TPU_DEVICE_CROPS=None,
              YOMITOKU_TPU_REC_WIDTH_BUCKETS=None):
        import cv2

        ctx = {"document_analyzer": prepared_analyzer(
            cv2.imread(str(ROOT / "demo" / "sample_table.png")))}
    paths, numbers = phase_cli(card, ctx)
    log(card)
    print(json.dumps({"launches_by_path": paths, "cli": numbers}), flush=True)
    return 0


def semantic_only(root):
    """``--semantic``: phase 9's analyzer setup (prepared_analyzer), then
    phase 11 (the TableSemanticParser path and the rule-extraction CLI), on
    this checkout's package."""
    from yomitoku_tpu_torch.ops import _build

    if root != ROOT:
        raise SmokeFailure("--semantic runs on this checkout only")
    card = card_line()
    log(f"card: {card}")
    t0 = time.perf_counter()
    _build.library()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    with _env(YOMITOKU_TPU_INT8_KV=None, YOMITOKU_TPU_INT8_ENCODER=None,
              YOMITOKU_TPU_HOST_CROPS=None, YOMITOKU_TPU_DEVICE_CROPS=None,
              YOMITOKU_TPU_REC_WIDTH_BUCKETS=None):
        import cv2

        ctx = {"document_analyzer": prepared_analyzer(
            cv2.imread(str(ROOT / "demo" / "sample_table.png")))}
    paths, numbers = phase_semantic(card, ctx)
    log(card)
    print(json.dumps({"launches_by_path": paths, "semantic": numbers}), flush=True)
    return 0


def document_only(root):
    """``--document``: phase 9 (the DocumentAnalyzer path) alone, on this
    checkout's package, with the synthetic 136-line page of phase 3."""
    from yomitoku_tpu_torch.ops import _build

    if root != ROOT:
        raise SmokeFailure("--document runs on this checkout only")
    card = card_line()
    log(f"card: {card}")
    t0 = time.perf_counter()
    _build.library()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    page, quads = synthetic_lines_page()
    paths, numbers = phase_document(card, dict(page=page, quads=quads))
    log(card)
    print(json.dumps({"launches_by_path": paths, "document": numbers}), flush=True)
    return 0


#: the modes that run one part on the package at ROOT
MODES = {"--fused-kernels": fused_kernels_only, "--deform-kernels": deform_kernels_only,
         "--attention-kernels": attention_kernels_only,
         "--page": page_only, "--document": document_only, "--cli": cli_only,
         "--semantic": semantic_only, "--dp": dp_only, "--tp": tp_only, "--lite": lite_only}


def main():
    try:
        import torch
    except ImportError:
        log("FAIL: torch is not installed")
        return 1
    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is false: no GPU to run on")
        return 1
    args = sys.argv[1:]
    mode = MODES.get(args[0]) if args else None
    root = Path(args[1]).resolve() if mode and len(args) > 1 else ROOT
    if not (root / "yomitoku_tpu_torch" / "csrc").is_dir():
        log(f"FAIL: {root} holds no yomitoku_tpu_torch checkout")
        return 1
    sys.path.insert(0, str(root))
    if mode:
        try:
            return mode(root)
        except SmokeFailure as e:
            log(f"FAIL: {e}")
            return 1
    if args:
        log(f"FAIL: unknown arguments {args} (none, or --fused-kernels [ROOT], "
            "--deform-kernels [ROOT], --attention-kernels [ROOT], --page, --document, --cli, "
            "--semantic, --dp, --tp or --lite)")
        return 1
    took, t_run = {}, time.perf_counter()

    def timed(phase, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            took[phase] = round(took.get(phase, 0) + time.perf_counter() - t0, 1)

    try:
        card = timed(1, phase_card)
        kernels = timed(2, phase_kernels)
        gemm_shapes = timed(2, phase_gemm)
        layout_kernels = timed(2, phase_layout_kernels)
        kernels.update(timed(5, phase_int8_kernels))
        int8_gemms, quants = timed(5, phase_gemm_int8)
        shaped = timed(7, phase_fused_kernels)  # {kernel: {label: numbers}}
        ocr_launches, ctx = timed(3, phase_slice, card)
        paths = {"ocr": ocr_launches, "layout": timed(4, phase_layout, card)}
        paths["int8_recognizer"], int8_numbers = timed(6, phase_int8_recognizer, card, ctx)
        paths["fused_backbone"], fused_numbers = timed(7, phase_fused_backbone, card)
        page_paths, page_numbers = timed(8, phase_page, card, ctx)
        paths.update(page_paths)
        document_paths, document_numbers = timed(9, phase_document, card, ctx)
        paths.update(document_paths)
        cli_paths, cli_numbers = timed(10, phase_cli, card, ctx)
        paths.update(cli_paths)
        semantic_paths, semantic_numbers = timed(11, phase_semantic, card, ctx)
        paths.update(semantic_paths)
        dp_paths, dp_numbers = timed(12, phase_dp, card, ctx)
        paths.update(dp_paths)
        tp_paths, tp_numbers, tp_kernels = timed(13, phase_tp, card, ctx)
        paths.update(tp_paths)
        lite_paths, lite_numbers, lite_kernels = timed(14, phase_lite, card, ctx)
        paths.update(lite_paths)
    except SmokeFailure as e:
        log(f"FAIL: {e}")
        return 1
    log(f"phases took (s): {took}; the run "
        f"{time.perf_counter() - t_run:.1f} s")
    log(f"profiler windows with launches not a whole number per call: "
        f"{len(_ragged_windows)} (kernel: launches in 10 calls) {_ragged_windows[:3]}")
    (OUT / "int8_recognizer.json").write_text(json.dumps(int8_numbers, indent=1))
    (OUT / "fused_backbone.json").write_text(json.dumps(fused_numbers, indent=1))
    (OUT / "page_route.json").write_text(json.dumps(page_numbers, indent=1))
    (OUT / "document.json").write_text(json.dumps(document_numbers, indent=1))
    (OUT / "cli.json").write_text(json.dumps(cli_numbers, indent=1))
    (OUT / "semantic.json").write_text(json.dumps(semantic_numbers, indent=1))
    (OUT / "dp.json").write_text(json.dumps(dp_numbers, indent=1))
    (OUT / "tp.json").write_text(json.dumps(tp_numbers, indent=1))
    (OUT / "lite.json").write_text(json.dumps({"numbers": lite_numbers, "kernels": lite_kernels},
                                              indent=1, default=str))
    log(card)  # as nvidia-smi prints it: name, power limit
    for name, at in layout_kernels.items():
        shaped.setdefault(name, {}).update(at)
    for name, at in tp_kernels.items():  # kernels 1-4 at parseq's D 512 (phase 13)
        shaped.setdefault(name, {})["d512"] = at
    for name, at in lite_kernels.items():  # 1-4, 6-8 at parseq-tiny's / -small's (phase 14)
        shaped.setdefault(name, {}).update(at)
    for name, labels in GEMMS_OF.items():  # the GEMM kernel's shapes inside each row
        shaped.setdefault(name, {}).update({f"gemm_{lb}": gemm_shapes[lb] for lb in labels})
    for name, (labels, qlabels) in INT8_GEMMS_OF.items():  # and the int8 kernels'
        shaped.setdefault(name, {}).update({f"gemm_int8_{lb}": int8_gemms[lb] for lb in labels})
        shaped[name].update({f"quantize_rows_{lb}": quants[lb] for lb in qlabels})
    rows = []
    for name, route, src, more, replaces in KERNELS:
        by_path = {p: n[name] for p, n in paths.items() if n[name]}
        numbers = dict(kernels.get(name, {}))
        at = shaped.get(name, {})
        if name in MAIN_SHAPE:
            numbers.update(at[MAIN_SHAPE[name]])
        rows.append(dict(
            name=name, route=route, source=src, sources=[src] + more,
            replaces=replaces, launches=sum(by_path.values()),
            launches_by_path=by_path, **numbers, at=at,
        ))
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
