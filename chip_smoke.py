#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # from the repository root, one NVIDIA card

Phases, one line each, every failure fatal (non-zero exit, no result line):

  build    compile every CUDA kernel from ``src/repro_torch/kernels/csrc``
           (one ``nvcc`` per source, all started together) and print K3's,
           K2's, K1's and K4's ``ptxas -v`` lines per instantiation
           (registers, spills, the shared memory their tile plans ask for);
  kernels  run each kernel at the main path's shapes and hold it against its
           plain PyTorch version bit for bit: K3 (timed beside its yardstick
           ``torch._int_mm`` on x padded to 17 rows; tail shapes, -128
           inputs and wrapping centers besides), K2 (at the lossless 24b
           ADC and at the paper's 7b ADC, where failures and recovery must
           occur, both timed; tails: B = 2, 3, 9, 17, 65, R = 1000, 1001 and
           2816, C = 1000 and 1008, 1 and 8 planes with a padded one, the
           (8,) spec slicing and centers across the int32 range), K1 with
           1b input slices at B = 1, 4, 16, 64 (7b runs must saturate),
           with (4,2,2), (8,) slicings and a ragged plane mask, and at
           K2's kind of tails (``K1_TAILS``); K4, K1, K4, K2, K1, K4
           launched back to back on one stream, K1 and K2 each with its own
           counters; K4 with 8 one-bit input slices and 3 planes at the
           site shapes at B = 1, 4, 16 and 64 (timed at B = 4), and at
           ``K4_TAILS`` (1, 3 and 8 slices and planes, R = 1 to 2816, C =
           7 to 151936, int8 values -128..127 on both sides, mults that
           wrap the int32 result), at 24b and 7b, where the clamps must
           bite (the result differs from the 24b one);
  serve    build qwen1.5-0.5b at its published size (random weights from a
           seed, bf16), compile its PIM plans and serve 4 requests through
           ``ContinuousServeEngine`` in ``exact``, ``int8`` and ``fast``
           mode, then ``exact`` with speculation off (the static-slicing
           kernel K1 on the pinned plans) and ``exact`` with adaptive
           slicing (Algorithm 1 per site through K1 at compile time);
           launch counts are zeroed before and read after each run; every
           exact run's tokens must equal the int8 tokens at the 24b ADC;
           then Algorithm 1's compile again under ``torch.profiler`` (K1's
           device time in it), a sampled request (temperature 1.0)
           whose stream must be the same in both engines for one seed,
           and ``PagedServeEngine`` (blocks of 16, max_len 32 in every
           run): ``paged-exact`` (K2) under a pool of 5 blocks that must
           evict, its tokens the continuous exact tokens; ``paged-prefix``
           (K3), 4 requests sharing a 32-token prefix, 6 prefix-block
           hits, its tokens the continuous engine's at the same chunks;
           ``paged-int8kv`` (K3, int8 KV cache), its tokens the continuous
           engine's under the same cache; both int8-KV runs again under
           ``torch.profiler`` (every kernel's device time);
  telemetry ``repro_torch.obs`` on the serve phase's model, pinned exact
           plans and 4 requests: continuous exact with metrics and tracing
           on (tokens equal the serve phase's, run with telemetry off; live
           counters equal ``ServeStats``; TTFT and e2e observed once a
           request, TPOT once a decode token; one trace lane per request);
           exact at the paper's 7b ADC on one request, whose
           ``repro_pim_*_total`` counters (K2's) must equal a
           ``with_pim_stats`` replay of its decode steps, with speculation
           failures, and whose pJ/token gauge must equal the energy model
           on them, then on all 4 (converts, failure rate, saturations and
           pJ per decode token printed); paged exact on 5 blocks (it must
           evict; the pool series equal ``ServeStats``); the launcher with
           ``--metrics-out``, ``--trace-out`` and ``--profile-dir`` (the
           profiler's trace must name K2's kernel); the decode step with
           telemetry off and on, in exact and fast, in turns (recorded, not
           gated);
  nonideal device nonidealities and ADC noise on the serve phase's model,
           pinned exact plans and 4 requests (3 new tokens each) at the
           paper's 7b ADC: the
           ideal array with speculation off (K1), then ``NonidealSim``
           dies (no kernel; 1b static input slicing) at the nominal corner
           (its tokens must equal the ideal run's), 1-sigma seed 0 twice
           (equal tokens), 1-sigma seed 1 and 3-sigma, each die's share of
           tokens equal to the ideal run's, step time and peak printed;
           every crossbar call of one decode step (338) through the
           nominal die's loop and K1, psum and saturations bit for bit;
           one decode step's head and FFN-up inputs on each corner: the
           output-code error must be 0 / rise / rise at the 24b ADC; on
           the 1-sigma die the head's and the down projection's stuck
           counts within 6 sd of their binomial means, no fault on padding
           rows, std(log G/G0) within 5% of ``program_sigma``; a padded
           plane stays zero at 3-sigma; a 3-sigma read of the head within
           1e-5 of float64; the ADC noise model on the FFN up projection
           (64 rows): noise 0 with a key == K2, one key one result, the
           error rising over noise 0.04 / 0.08 / 0.12 with speculation on
           and off, Algorithm 1 at noise 0.10 on no fewer slices; the
           step's program and read device time (CUDA events, per
           distinct shape times its calls); the launcher with
           ``--device-corner 1sigma``; ``--phases build,serve,nonideal``
           runs it;
  disagg   the paged engine's disaggregated prefill/decode mode: two
           processes on ``cuda:0``, a prefill rank and a decode rank of one
           ``gloo`` group (a FileStore in a temporary directory; NCCL
           takes one rank per card), slices
           ``make_disaggregated_meshes((1, 1, 1), (1, 1, 1))``. Each rank
           builds qwen1.5-0.5b at its published size (bf16, the serve
           phase's seed) with its pinned exact and fast plans at the 24b
           ADC; per-leaf checksums of both trees must be equal across the
           ranks. The serve phase's 4 requests (max_len 32, blocks of 16)
           in ``disagg-exact`` (K2, a 5-block pool that must evict) and
           ``disagg-fast`` (K3): launches per rank equal the plans'
           per-call count times the prefill chunks (prefill rank) or the
           decode steps (decode rank); the first engine call's kernel
           calls on each rank (338 K2 / 169 K3) held bit for bit against
           the plain version; handoff bytes and ms per request beside
           bytes / 3.35 TB/s, median decode step ms, evictions; tokens
           equal to the one-process paged and continuous engines' on the
           same trace, run on the decode rank after the disaggregated
           runs (and to the serve phase's, when it ran);
  examples the port's last three examples as subprocesses on the card,
           all three at once (``python -m repro_torch.examples.<name>``,
           through ``runpy``): quickstart (Algorithm 1 through K1, a slicing
           chosen, ``forward_exact`` through K2 with converts saved > 0,
           ``forward_fast`` through K3, rel errors, ResNet18), serve_quantized
           (K3 on the LM head, its rel error) and pim_accuracy_demo
           (Table 4's keys, K1 and K2); wall times and launches printed;
  train    training on the card, no kernel on its path (``pim_mode``
           off; every kernel's launch count must stay 0): one
           ``make_grad_fn`` step of reduced qwen1.5-0.5b and reduced
           phi3.5-moe-42b (float32, vocab 64) on the card and on the CPU
           from the same weights and batch, with 1 and 4 micro-batches,
           losses to 1e-5 relative and every gradient leaf to the CPU
           tests' tolerance, then one ``make_train_step`` (params by
           relative global norm); qwen1.5-0.5b at its published size (bf16,
           remat, float32 AdamW moments) through ``train_loop.train`` with
           a straggler monitor, 20 steps at 8 x 64 tokens from a
           ``SyntheticLM`` of 8,192 data tokens (the model keeps its
           151,936 outputs), the loss falling by 0.3, then 5 steps at 8 x
           1,024 tokens with 2 micro-batches (step ms, tokens/s, peak GiB,
           model TFLOP/s printed); ``resilient_train`` on reduced qwen
           with a failure injected at step 12 reaching step 20; card ->
           CPU and CPU -> card checkpoints restored bit for bit; the
           launcher ``python -m repro_torch.launch.train --reduced
           --resilient`` as a subprocess; ``--phases build,train`` runs it;
  dist     the distribution layer on a one-rank NCCL group (a FileStore in
           a temporary directory; destroyed at the phase's end): a 1x1
           ``("data", "model")`` and a 1x1x1 pod mesh on the card, the
           production meshes refusing one rank; qwen1.5-0.5b at published
           size placed under DEFAULT_RULES and SERVE_RULES, its exact plans
           by ``plan_specs`` and a paged decode state by ``cache_specs``
           under MULTIPOD_SERVE_RULES, each leaf gathered back bit for bit
           (placement ms printed); 3 train steps of 8 x 64 tokens under the
           mesh and without one from one start, losses and parameters
           equal bit for bit, both median step ms printed;
           ``compressed_psum`` over "data" on a full-width gradient tree
           with an error carry equal to ``compress_decompress`` (three
           leaves also to the CPU's), timed beside its byte bound; the
           placed parameters (and a reduced AdamW state) saved and restored
           with ``shardings=`` onto the pod mesh under MULTIPOD_RULES, bit
           for bit (the partitioned program on one rank: every
           collective an identity, the loss on its plain path); K1-K4
           launches must stay 0; ``--phases dist`` runs it alone (~30 s);
  tp       the partitioned train step and prefill (``dist.parallel``:
           FSDP, tensor and sequence parallel, MoE FFNs expert parallel,
           mamba over d_inner channels, rwkv6 over whole heads):
           4 processes on ``cuda:0``
           in one ``gloo`` group (a FileStore in a temporary directory),
           mesh (2, 2) under DEFAULT_RULES, qwen1.5-0.5b at its published
           widths cut to ``TP_QWEN_LAYERS`` of its 24 layers, from seed 0
           with ``pim_mode`` off, then phi3.5-moe-42b at
           its published widths cut to ``TP_MOE_LAYERS`` layers (one
           float32 train step of ``TP_MOE_ROWS`` x 64 tokens, its loss
           and grad norm held; the same prefill and decode), then
           rwkv6-3b at its published widths cut to
           ``TP_RECURRENT_LAYERS`` layers (as qwen), then
           jamba-1.5-large-398b's first ``TP_RECURRENT_LAYERS`` layers
           (mamba + MoE, mamba + dense) on a ``TP_JAMBA_MESH`` mesh, a
           bf16 prefill and decode alone: 2 train steps in float32
           of 8 x 64 tokens (the train phase's ``SyntheticLM``), losses,
           grad norms and the gathered parameters held against the
           one-process run on the card to the train phase's card-vs-CPU
           tolerances; a prefill in bf16 of 4 x 256 tokens, the ranks'
           logits blocks (rows x vocab shards) and cache blocks (rows x
           sequence blocks) assembled within ``TP_PREFILL_RTOL`` of the
           one-process prefill; then the partitioned decode
           (``parallel.ServePartition``) under SERVE_RULES on the same
           mesh: the one-process prefill of those prompts into caches of
           ``TP_DECODE_LEN`` placed by ``cache_specs`` (both "model"
           blocks written: the prompt's by the prefill, the new tokens'
           by the decode), the weights by ``param_specs``, then
           ``TP_DECODE_STEPS`` greedy steps (ids over the vocab shards,
           ``ServePartition.greedy``), in bf16 and in float32: the
           logits assembled by vocab within ``TP_DECODE_RTOL`` (bf16) or
           ``TP_DECODE32_RTOL`` of the one-process decode fed the same
           tokens, the greedy tokens equal to the one-process greedy
           run's (float32 holds them where a bf16 near-tie could break
           them). Per rank and step: collectives
           by op, their bytes, the bytes staged through host memory
           (gloo's all-gather on CUDA, ``parallel.GLOO_DEVICE_OPS``) and
           the step ms, labelled host-staged (phi's lines also its
           rank's experts and its train step's peak; the prefill's its
           rank's d_inner block and rwkv heads); the recurrent carries
           assembled by rows and by d_inner block or heads; phi's and
           jamba's bf16 one-process references take the ranks' experts
           (``forced_routes``); K1-K4 launches must stay 0 on every
           rank;
  dryrun   the dry run (``repro_torch.launch.dryrun``): the cells of
           jamba-1.5-large-398b, phi3.5-moe-42b and qwen1.5-0.5b on both
           meshes, then the decode_32k cells of the other four dense
           attention archs and of rwkv6-3b (30 of the 62; the whole sweep
           takes longer
           than this script may, ``--all`` runs it) on fake tensors and
           fake 256/512-rank groups, as ``python -m
           repro_torch.launch.dryrun --arch ... --jobs N`` in a subprocess
           started with the script at the lowest CPU priority, so that it
           runs on the host's idle cores during the earlier phases, every cell ``ok``, one line per cell (GiB
           per device, fits, the three roofline terms, the bound), the
           fits count and the bounds' histogram; meanwhile
           qwen1.5-0.5b's per-rank programs of ``decode_32k``,
           ``prefill_32k`` and ``train_4k`` on the 16x16 mesh (8
           sequences' 2,048-position block of a 32,768-position cache,
           every token of the 128; 2 x 32,768 prompt tokens; 16 x 4,096
           train tokens) run for real on the card (weights from seed 0,
           zeroed caches and tokens, bf16; all three are the partitioned
           programs, run as rank 0 of a fake 256-rank group destroyed
           afterwards, train with grad enabled), rwkv6-3b's partitioned
           ``decode_32k`` program (its 8 rows' recurrent state, every
           head, its blocks of the stationary weights), and the
           partitioned ``decode_32k`` programs of phi3.5-moe-42b cut to
           ``DRYRUN_MOE_LAYERS`` layers and of jamba-1.5-large-398b cut
           to ``DRYRUN_JAMBA_LAYERS`` (``DRYRUN_CUT``: their whole depths
           do not fit one card to place from), each held to the dry run
           of the same cut config, run in this process:
           ``FlopCounterMode``'s count must equal the sweep's
           ``hlo_flops_per_device``, ``max_memory_allocated`` must lie
           within 15% of its ``per_device_bytes``, and the median of 5
           timed runs is printed beside ``compute_s``, ``memory_s`` and
           the roofline fraction reached; K1-K4 launches must stay 0;
           ``--phases dryrun`` runs it alone;
  moe      phi3.5-moe-42b at its published widths, 4 of its 32 layers
           (random bf16 weights from a seed): the same 4 requests through
           ``ContinuousServeEngine`` in ``exact`` (K2 per expert),
           ``int8``, ``fast`` (K3 per expert) and ``exact`` with Algorithm
           1 per (layer, expert) through K1; launches per engine call
           counted from the plans (418 K2, 209 K3), exact == int8 ==
           exact-adaptive tokens, empty expert buffers at calibration and
           peak memory printed; at capacity 8.0, where no slot can drop,
           exact through the continuous and (on 5 blocks, evicting) the
           paged engine, fast through the lockstep, continuous and paged
           engines, tokens equal; every K2 call of one decode step (on
           the pinned and on Algorithm 1's plans) and every K3 call held
           bit for bit against the plain versions, psum and counters
           included, and timed; K1 at Algorithm 1's search shape (16
           rows, 1b input slices, 24b and 7b ADC) on expert matrices of
           each slice count, held the same way;
  hybrid   the recurrent blocks. rwkv6-3b whole at its published size (32
           layers, random bf16 weights from a seed; only its LM head is a
           crossbar site): the same 4 requests through
           ``ContinuousServeEngine`` in ``exact`` (K2), ``int8``, ``fast``
           (K3), ``exact`` with speculation off (K1) and with Algorithm 1
           on the head (K1 at compile time), launches per engine call from
           the plans, exact == int8 == exact-nospec == exact-adaptive
           tokens; exact through the lockstep engine and the paged engine
           (staged B=1 prefill, 5 blocks, evicting), tokens equal; a
           sampled request; every K2, K1 and K3 call of one decode step
           held bit for bit against the plain versions. One
           jamba-1.5-large-398b layer at its published widths (pattern
           position 1: mamba mixer, d_inner 16384, and a dense FFN of
           24576) through ``transformer.run_layer``, its plans from
           ``pim_compile.compile_layer``: 4 prefills and 7 decode steps of
           4 slots on the pinned exact, int8, fast and Algorithm 1's plans,
           launches counted, exact == int8 == adaptive outputs; every K2
           and K3 call of one decode step and K1 at Algorithm 1's 16-row
           search shape on the six matrices held bit for bit and timed
           beside their byte bounds. jamba-1.5-large-398b whole at
           ``reduced()`` widths: every K2 call of one decode step held bit
           for bit against the plain version at the narrow shapes it
           gives; exact mode's lockstep == continuous == paged (staged,
           evicting) tokens, equal to int8 mode's;
  encoder  the encoder-only models whole at their published sizes (random
           bf16 weights from a seed): raella-bert-large (24 layers, the
           paper's own transformer) on token ids and hubert-xlarge (48
           layers) on frame embeddings, 4 sequences of 384 positions, so
           every projection gets 1,536 rows. ``transformer.forward`` in
           ``off``, ``exact`` (K2), ``int8``, ``fast`` (K3), ``exact`` with
           speculation off (K1) and ``exact`` on Algorithm 1's plans (K1 at
           compile time, then K2): launches counted from the plans, exact,
           exact-nospec and adaptive logits equal to int8's; one call of
           each distinct shape the forward gives K2 (pinned and Algorithm
           1's plans), K1 and K3, and K1 at the 16-row search shape, held
           bit for bit against the plain versions; each kernel's calls of
           one forward timed beside their bound (K3 also beside
           ``torch._int_mm``); ``lm_loss`` of each model; and for bert an
           exact forward at the paper's 7b ADC with every layer's work
           stats (converts per position, speculation-failure share);
  decoders the last three dense decoders at their published widths, depth
           cut to fit the card (``DECODERS``; random bf16 weights from a
           seed): chameleon-34b (qk-norm), 4 of 48 layers, qwen2.5-32b, 4 of
           64, and qwen1.5-110b, 2 of 80 (QKV bias). Each serves the same 4
           requests through ``ContinuousServeEngine`` in ``exact`` (K2),
           ``int8`` and ``fast`` (K3), chameleon also ``exact`` on
           Algorithm 1's plans (K1 in the compile, then K2): launches per
           engine call from the plans, exact == int8 tokens (== adaptive),
           peaks, converts per token and each exact compile's energy
           report (``CompiledPim.report``); every K2 call of one decode
           step (pinned, and chameleon's Algorithm 1 plans) and every K3
           call held bit for bit against the plain versions, the head
           included, timed beside their bound (K3 also beside
           ``torch._int_mm``); K2 at the 7b ADC on the down projection
           (up to 96 segments), counters included; K1 at Algorithm 1's
           search shape on chameleon's distinct (R, C) (timed) and on the
           others' down projections;
  paper    the paper's tables and figures through ``repro_torch.paper``:
           every ``ENTRIES`` item at its full default kwargs on the card
           (Table 4's die sweep over nominal, 1-sigma and 3-sigma), wall
           time, result and launches per entry (fig3 K2; table4 and fig15
           K1 and K2; fig15's corners and compile_report K1, in Algorithm
           1; the die sweeps and the analytic entries none); the scripts'
           own asserts (table1's, fig3's monotonicity, table4's four);
           table1, fig3, table2, fig12-14 and lm_on_pim ``==`` the
           reference's values (``PAPER_RECORDED``); the nominal die's
           Fig. 15 accuracy == the ideal array's; every K1 and K2 call
           the artifacts made on operands not seen before (known by their
           contents, not their shapes: Fig. 15's ISAAC arm at 128-row
           segments and B = 2,048, Table 4's Zero+Offset and
           Center+Offset plans at B = 10 and 2,048 and C = 512 and 8,
           fig3's call, Algorithm 1's search on each site) held bit for
           bit against the plain versions,
           psum and counters, and timed beside its bound; K1, K2 and K4
           at 128, 256 and 384-row segments (``SHORT_CASES``) bit for bit;
           ``--phases build,paper`` runs it alone;
  timing   one decode step's worth of kernel calls on the compiled plans
           (distinct weights per layer, as the model has them) against the
           plain versions and, for K3, ``torch._int_mm`` (x padded with zero
           rows); K2 also on Algorithm 1's adaptive plans; K4 at the four
           projection shapes at B = 4 and 64 on distinct weights per
           repeat; K1 at B = 16 with batch tiles of 1, 2 and 4
           rows; the copies the paged engine adds to a decode step (block
           gathers, int8 dequantize), device and host time; the moe
           phase's K2 and K3 step times beside qwen's.

Before the last line it prints one JSON object ``{"kernels": [...]}``:
each kernel's entry gives its launches on the qwen path and its decode
step's times, its ``max_abs_err`` over every comparison of the run, and
``moe_launches`` (the moe phase's own run; K1's are Algorithm 1's
compile) with ``moe_max_abs_err`` (the moe phase's comparisons),
``moe_ms``, ``moe_plain_ms``, ``moe_bound_ms``, ``moe_bound_by`` and
``moe_library_ms`` for the MoE decode step, null where not measured, and
the hybrid phase's ``hybrid_launches`` (rwkv6-3b's runs: K2 in exact, K3
in fast, K1 in exact-nospec), ``hybrid_max_abs_err`` (its comparisons)
and ``hybrid_ms``, ``hybrid_plain_ms``, ``hybrid_bound_ms``,
``hybrid_bound_by`` and ``hybrid_library_ms`` for the jamba layer's
decode step (K1: its search shape); K4's entry is its B = 4 timing, with
``b64_ms``, ``b64_plain_ms``, ``b64_bound_ms``, ``b64_bound_by`` and
``b64_library_ms`` at B = 64. With the encoder phase, K1's, K2's and
K3's entries add ``encoder_launches`` (each kernel's launches in one
forward of each encoder model: K2 in exact, K1 in exact-nospec, K3 in
fast), ``encoder_max_abs_err`` (the phase's comparisons) and
``encoder_ms``, ``encoder_bound_ms``, ``encoder_bound_by`` and
``encoder_library_ms`` for those forwards' calls at 1,536 rows, summed
over the two models (K4's: 0 launches, null). With the decoders phase
they add ``decoders_launches`` (K2 in the three exact runs, K3 in the
three fast runs, K1 in chameleon's Algorithm 1 compile),
``decoders_max_abs_err`` and ``decoders_ms``, ``decoders_bound_ms``,
``decoders_bound_by`` and ``decoders_library_ms`` for one decode step of
each model (K1: chameleon's search shape), summed over the models.
With the disagg phase they add ``disagg_launches`` (both ranks' K2 in
disagg-exact and K3 in disagg-fast; K1 and K4: 0) and
``disagg_max_abs_err`` (its comparisons); with the examples phase,
``examples_launches`` (the three examples' runs together).
With the paper phase they add ``paper_launches`` (the artifacts' runs),
``paper_max_abs_err`` (its comparisons) and ``paper_ms``,
``paper_plain_ms``, ``paper_bound_ms``, ``paper_bound_by`` and
``paper_library_ms`` over each distinct call the artifacts made, once
each (K3 and K4: 0 launches, null). The last line is ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

ARCH = "qwen1.5-0.5b"
# H100 SXM published peaks (NVIDIA data sheet), used for bound_ms
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
# the main path's (rows, cols) per projection of qwen1.5-0.5b
SITE_SHAPES = {"qkvo": (1024, 1024), "up": (1024, 2816), "down": (2816, 1024),
               "head": (1024, 151936)}
BATCHES = (1, 4, 64)
K1_BATCHES = (1, 4, 16, 64)  # 16: Algorithm 1's search rows
SPEC = (4, 2, 2)
ONE_BIT = (1,) * 8           # Algorithm 1's input slicing
BLOCK = 16                   # the paged runs' KV tokens per pool block
MOE_ARCH = "phi3.5-moe-42b"
# of its 32 layers: the whole model (42 G parameters, 84 GB in bf16) does
# not fit one card
MOE_LAYERS = 4
# capacity E / k = 16 / 2: cap >= B at decode and >= S in prefill, so no
# slot can drop and every engine routes every token alike
DROP_FREE_CF = 8.0
N_SLOTS = 4                  # every serve run's slots, the decode batch
RWKV_ARCH = "rwkv6-3b"
JAMBA_ARCH = "jamba-1.5-large-398b"
# jamba's pattern position 1: a mamba mixer and a dense FFN. Its smallest
# whole depth, one 8-layer pattern repeat (45.2 G parameters, 90.5 GB in
# bf16), does not fit the card, so this layer runs alone
JAMBA_LAYER = 1
JAMBA_DECODES = 7
ENCODER_ARCHS = ("raella-bert-large", "hubert-xlarge")
# the paper's BERT-Large sequence length (its analytic model's
# bert_large_ffn(seq=384)); for hubert, 7.7 s of audio at 50 frames/s
ENCODER_BATCH, ENCODER_SEQ = 4, 384
ENCODER_ROWS = ENCODER_BATCH * ENCODER_SEQ  # rows every projection gets
# (arch, layers run, Algorithm 1 too): published widths, depth cut so that
# params, plans and the compile's temporaries fit the card (whole, they
# are 68.6, 65.5 and 222.4 GB in bf16)
DECODERS = (("chameleon-34b", 4, True), ("qwen2.5-32b", 4, False),
            ("qwen1.5-110b", 2, False))
# the dry run's per-rank programs held against the card, (arch, shape) on
# the 16x16 mesh, all partitioned: qwen1.5-0.5b's three programs and
# rwkv6-3b's decode; and the decode_32k programs of the MoE models cut in
# depth, (arch, layers): phi3.5-moe-42b's whole 32 layers take 84 GB in
# bf16 to place from, jamba-1.5-large-398b's smallest whole depth 90.5 GB;
# 4 layers of jamba's pattern (mamba + MoE, mamba, mamba + MoE, attention)
# take 46 GB. Then its timed runs, the peak-memory tolerance, the archs swept
# on both meshes (the longest cells first), the sweep's worker processes
# (the host's cores less the main process's) and its limit. The
# whole sweep, all 62 cells, takes longer than this script may:
# run it by hand with
# ``python -m repro_torch.launch.dryrun --all --jobs N``
DRYRUN_PROGRAMS = ((ARCH, "decode_32k"), (ARCH, "prefill_32k"),
                   (ARCH, "train_4k"), (RWKV_ARCH, "decode_32k"))
DRYRUN_MOE_LAYERS = 4
DRYRUN_JAMBA_LAYERS = 4
DRYRUN_CUT = ((MOE_ARCH, DRYRUN_MOE_LAYERS),
              (JAMBA_ARCH, DRYRUN_JAMBA_LAYERS))
DRYRUN_ARCHS = ("jamba-1.5-large-398b", "phi3.5-moe-42b", ARCH)
# the decode cells of the other dense attention archs and of rwkv6-3b
DRYRUN_DECODE_ARCHS = ("qwen1.5-110b", "qwen2.5-32b", "chameleon-34b",
                       "yi-6b", "rwkv6-3b")
DRYRUN_RUNS = 5
DRYRUN_MEM_TOL = 0.15
DRYRUN_JOBS = max(1, min(6, (os.cpu_count() or 2) - 2))
DRYRUN_SWEEP_TIMEOUT = 900


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of one call of ``fn`` over ``reps`` calls.

    CUDA events around each call, with the device held busy
    (``torch.cuda._sleep``) while the host enqueues it: the events then
    time the kernels back to back, not the host's launch overhead between
    them (which the serve phase's step times include). One call's launches
    must fit the device's launch queue (about a thousand) for this to hold.
    """
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(reps):
        # ~2x the host's enqueue time, at most ~0.5 s
        torch.cuda._sleep(int(min(4e9 * host_s, 1e9)) + 1_000_000)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(stop)
    return total / reps


def toolchain(torch) -> str:
    """One line naming the host's toolchain as the port sees it."""
    import importlib.util
    from repro_torch.kernels import build
    nvcc = subprocess.run([build.nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    have = {m: importlib.util.find_spec(m) is not None
            for m in ("triton", "jax")}
    return (f"toolchain: python {sys.version.split()[0]} torch "
            f"{torch.__version__} (CUDA {torch.version.cuda}) nvcc "
            f"{nvcc[-1] if nvcc else '?'} triton={have['triton']} "
            f"jax={have['jax']} cutlass="
            f"{Path('/usr/local/cutlass/include').is_dir()}")


# ---------------------------------------------------------------- phases
def phase_build() -> None:
    from repro_torch.kernels import build, ops
    t0 = time.perf_counter()
    secs = build.build(list(ops.KERNELS))
    say("build", ok=True, seconds=round(time.perf_counter() - t0, 3),
        per_kernel=json.dumps({k: round(v, 3) for k, v in secs.items()}))
    # K3, K2, K1 and K4 per instantiation (batch tile, K1/K2/K4's segment
    # rows, load path): ptxas
    # -v registers and spills, and the most dynamic shared memory their
    # tile plans ask for
    from repro_torch.kernels import bitplane
    from repro_torch.kernels import int8_matmul as im

    def bitplane_entry(m, x="codes"):
        return dict(bt=int(m[1]), rows=128 * int(m[2]),
                    cp_async=m[3] == "1", smem_bytes_max=max(bitplane.smem_bytes(int(m[1]), c, x)
                                       for c in range(
                                           1, bitplane.MAX_CLUSTER + 1)))
    entries = {
        "centered_int8_matmul": (
            r"int8_kernelILi(\d)ELb([01])E",
            lambda m: dict(bt=8 * int(m[1]), cp_async=m[2] == "1",
                           smem_bytes_max=im.smem_bytes(8 * int(m[1]),
                                                        im.MAX_CLUSTER))),
        "fused_spec_crossbar": (r"spec_kernelILi(\d)ELi(\d)ELb([01])E",
                                bitplane_entry),
        "fused_crossbar": (r"crossbar_kernelILi(\d)ELi(\d)ELb([01])E",
                           bitplane_entry),
        "sliced_crossbar": (r"sliced_kernelILi(\d)ELi(\d)ELb([01])E",
                            lambda m: bitplane_entry(m, "slices"))}
    for name, (pattern, fields) in entries.items():
        entry = None
        for line in build.LOGS.get(name, "").splitlines():
            m = re.search("Compiling entry.*" + pattern, line)
            if m:
                entry = fields(m)
            elif entry is not None and "spill" in line:
                entry["spill_bytes"] = sum(map(int, re.findall(
                    r"(\d+) bytes spill", line)))
            elif entry is not None and "Used" in line:
                entry["registers"] = int(re.search(r"Used (\d+) reg",
                                                   line)[1])
                say("build", kernel=name, **entry)
                entry = None


def k2_inputs(B: int, R: int, C: int, gen):
    """Random operands with the value ranges of a (4,2,2) encoding and the
    unsigned codes of one signed pass (0..127)."""
    import torch
    dev = "cuda"
    n_seg = -(-R // 512)
    planes = torch.cat([
        torch.randint(-m, m + 1, (1, n_seg, 512, C), generator=gen,
                      device=dev, dtype=torch.int8) for m in (15, 3, 3)])
    planes[:, -1, R - 512 * (n_seg - 1):] = 0  # zero padding rows
    x = torch.randint(0, 128, (B, R), generator=gen, device=dev,
                      dtype=torch.int32)
    centers = torch.randint(1, 256, (n_seg, C), generator=gen, device=dev,
                            dtype=torch.int32)
    return x, planes, (4, 2, 0), centers


def phase_kernels(rows: list) -> None:
    import torch
    from repro_torch.core import adc as adc_lib
    from repro_torch.kernels import fused_spec_crossbar as fs
    from repro_torch.kernels import int8_matmul as im
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(0)
    for site, (R, C) in SITE_SHAPES.items():
        for B in BATCHES:
            # K3
            x = torch.randint(-127, 128, (B, R), generator=gen,
                              device="cuda", dtype=torch.int8)
            w = torch.randint(-127, 128, (R, C), generator=gen,
                              device="cuda", dtype=torch.int8)
            cen = torch.randint(-200, 200, (C,), generator=gen,
                                device="cuda", dtype=torch.int32)
            row = compare("centered_int8_matmul", im.launch(x, w, cen),
                          im.plain(x, w, cen), site=site, B=B, R=R, C=C)
            row["kernel_ms"] = cuda_ms(lambda: im.launch(x, w, cen), 5)
            row["plain_ms"] = cuda_ms(lambda: im.plain(x, w, cen), 2)
            lib = int_mm_args(x, w)
            row["library_rows"] = lib[0].shape[0]
            row["library_ms"] = cuda_ms(lambda: torch._int_mm(*lib), 5)
            rows.append(row)
            say("kernels", **row)
            # K2 at the lossless and the paper's ADC
            xu, planes, shifts, centers = k2_inputs(B, R, C, gen)
            tables = ops.spec_tables(planes, shifts, SPEC)
            for bits in (24, 7):
                adc = adc_lib.ADCConfig(bits=bits)
                kw = dict(adc_lo=adc.lo, adc_hi=adc.hi)
                got = fs.launch(xu, *tables, centers, **kw)
                row = compare("fused_spec_crossbar", got,
                              fs.plain(xu, *tables, centers, **kw),
                              site=site, B=B, R=R, C=C, adc_bits=bits,
                              fails=got[1].tolist(), rsats=int(got[2]))
                row["kernel_ms"] = cuda_ms(
                    lambda: fs.launch(xu, *tables, centers, **kw), 5)
                if bits == 24:
                    row["plain_ms"] = cuda_ms(
                        lambda: fs.plain(xu, *tables, centers, **kw), 1)
                elif not (int(got[1].sum()) > 0 and int(got[2]) > 0):
                    raise AssertionError("7b ADC run had no failures or no "
                                         "recovery saturations")
                rows.append(row)
                say("kernels", **row)
            del xu, planes, centers
    check_k3_tails(rows, gen)
    check_k2_tails(rows, gen)
    check_k1(rows, gen)
    check_k1_tails(rows, gen)
    check_interleaved(rows, gen)
    check_k4(rows, gen)
    summary = []
    for name, count in ops.launch_counts().items():
        mine = [r for r in rows if r["kernel"] == name]
        timed = [r for r in mine if "plain_ms" in r]
        lib = {B: [r for r in timed if r.get("library_ms") is not None
                   and r["B"] == B] for B in BATCHES}
        row = dict(
            name=name, launches=count, match=all(r["match"] for r in mine),
            checks=len(mine), max_abs_err=max(r["max_abs_err"] for r in mine),
            shapes=len(timed),
            kernel_ms=sum(r["kernel_ms"] for r in timed),
            plain_ms=sum(r["plain_ms"] for r in timed))
        for B, lrows in lib.items():  # K3 against torch._int_mm, per B
            if lrows:
                row[f"kernel_ms_B{B}"] = sum(r["kernel_ms"] for r in lrows)
                row[f"library_ms_B{B}"] = sum(r["library_ms"] for r in lrows)
        summary.append(row)
    say("kernels", ok=True, compared=len(rows), kernels=json.dumps(summary))


def compare(kernel: str, got, want, **fields) -> dict:
    """One bit-for-bit comparison row; raises on a mismatch."""
    import torch
    torch.cuda.synchronize()
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    match = all(torch.equal(g, w) for g, w in zip(got, want))
    row = dict(kernel=kernel, **fields, match=match, tolerance=0,
               max_abs_err=int((got[0].long() - want[0].long()).abs().max()))
    if not match:
        say("kernels", **row)
        raise AssertionError(f"{kernel} mismatch: {fields}")
    return row


INT_MM_MIN_ROWS = 17  # torch._int_mm on CUDA needs more than 16 rows


def int_mm_args(x, w) -> tuple:
    """``torch._int_mm``'s operands for x @ w, the library yardstick of K3:
    x padded with zero rows to the fewest rows it takes, w with zero
    columns up to a multiple of 8 (the bert head's 30522). It computes
    x @ w without the center term, a lower bound for the library; the port
    never calls it."""
    import torch
    B, K = x.shape
    if B < INT_MM_MIN_ROWS:
        x = torch.cat([x, x.new_zeros((INT_MM_MIN_ROWS - B, K))])
    pad = -w.shape[1] % 8
    return x, torch.nn.functional.pad(w, (0, pad)) if pad else w


def check_k3_tails(rows: list, gen) -> None:
    """K3 past the site shapes: K and N off the tiles (1000 takes the
    word-load path, 1040 x 1008 the cp.async path with ragged edges),
    batches of 3, 9, 17 and 65 rows, and x full of -128 against centers
    near the int32 limits, where y wraps modulo 2^32."""
    import torch
    from repro_torch.kernels import int8_matmul as im
    for K, N, B, extreme in ((1000, 1000, 3, False), (1000, 1000, 17, False),
                             (1040, 1008, 9, False), (1040, 1008, 17, False),
                             (1024, 1024, 65, False), (1024, 1024, 4, True),
                             (1000, 1000, 9, True), (1024, 2816, 64, True)):
        x = torch.randint(-128, 128, (B, K), generator=gen, device="cuda",
                          dtype=torch.int8)
        w = torch.randint(-128, 128, (K, N), generator=gen, device="cuda",
                          dtype=torch.int8)
        cen = torch.randint(-300, 300, (N,), generator=gen, device="cuda",
                            dtype=torch.int32)
        if extreme:
            x[:, ::2] = -128
            cen = torch.randint(-2**31, 2**31 - 1, (N,), generator=gen,
                                device="cuda", dtype=torch.int32)
        row = compare("centered_int8_matmul", im.launch(x, w, cen),
                      im.plain(x, w, cen), site="tail", B=B, R=K, C=N,
                      extreme=extreme)
        rows.append(row)
        say("kernels", **row)


# K2 tails (B, R, C, n_j, spec slicing, padded last plane, wrapping
# centers): C = 1000 and R = 1001 take the word-load path, C = 1008 the
# cp.async path with a ragged column tile; 2816 and 1000 rows leave the
# last segment ragged; 8 planes give clusters of 8 ranks; B = 1 (the site
# rows), 2 and 3 take batch tiles of 1, 2 and 4 rows
K2_TAILS = ((3, 1000, 1000, 3, SPEC, False, False),
            (9, 2816, 1008, 3, SPEC, False, True),
            (17, 1000, 1008, 8, SPEC, True, False),
            (65, 2816, 1000, 1, (8,), False, True),
            (4, 1024, 1024, 8, (8,), True, True),
            (9, 1000, 1000, 1, SPEC, False, True),
            (5, 1001, 1008, 3, SPEC, False, False),
            (64, 1024, 2816, 3, (8,), False, True),
            (2, 2816, 1024, 3, SPEC, False, True))


def check_k2_tails(rows: list, gen) -> None:
    """K2 past the site shapes (``K2_TAILS``), full 8b codes, at 24b and at
    7b, where failures and recovery saturations must occur."""
    from repro_torch.core import adc as adc_lib
    from repro_torch.kernels import fused_spec_crossbar as fs
    from repro_torch.kernels import ops
    for B, R, C, n_j, slicing, padded, wrap in K2_TAILS:
        xu, planes, shifts, valid, centers = tail_inputs(B, R, C, n_j, padded,
                                                         wrap, gen)
        tables = ops.spec_tables(planes, shifts, slicing, valid)
        for bits in (24, 7):
            adc = adc_lib.ADCConfig(bits=bits)
            kw = dict(adc_lo=adc.lo, adc_hi=adc.hi)
            got = fs.launch(xu, *tables, centers, **kw)
            row = compare("fused_spec_crossbar", got,
                          fs.plain(xu, *tables, centers, **kw), site="tail",
                          B=B, R=R, C=C, n_j=n_j, adc_bits=bits,
                          spec="-".join(map(str, slicing)), padded=padded,
                          wrap=wrap, fails=got[1].tolist(), rsats=int(got[2]))
            if bits == 7 and not (int(got[1].sum()) > 0 and int(got[2]) > 0):
                raise AssertionError(f"K2 tail {row} had no failures or no "
                                     "recovery saturations")
            rows.append(row)
            say("kernels", **row)
        del xu, planes, centers, tables


def check_k1(rows: list, gen) -> None:
    """K1 at Algorithm 1's input slicing over the site shapes and batch
    sizes (the search runs B = 16, nospec decode B = 4), then other input
    slicings and a ragged plane mask at one shape."""
    import torch
    from repro_torch.core import adc as adc_lib
    from repro_torch.kernels import fused_crossbar as fx
    from repro_torch.kernels import ops
    for site, (R, C) in SITE_SHAPES.items():
        for B in K1_BATCHES:
            xu, planes, shifts, centers = k2_inputs(B, R, C, gen)
            tables = ops.crossbar_tables(planes, shifts, ONE_BIT)
            for bits in (24, 7):
                adc = adc_lib.ADCConfig(bits=bits)
                kw = dict(adc_lo=adc.lo, adc_hi=adc.hi)
                got = fx.launch(xu, *tables, centers, **kw)
                row = compare("fused_crossbar", got,
                              fx.plain(xu, *tables, centers, **kw),
                              site=site, B=B, R=R, C=C, adc_bits=bits,
                              input_slicing="1x8", sats=int(got[1]))
                if bits == 24:
                    row["kernel_ms"] = cuda_ms(
                        lambda: fx.launch(xu, *tables, centers, **kw), 5)
                    row["plain_ms"] = cuda_ms(
                        lambda: fx.plain(xu, *tables, centers, **kw), 1)
                elif int(got[1]) == 0:
                    raise AssertionError("7b ADC run of K1 had no saturations")
                rows.append(row)
                say("kernels", **row)
            del xu, planes, centers, tables
    R, C = SITE_SHAPES["qkvo"]
    xu, planes, shifts, centers = k2_inputs(4, R, C, gen)
    xu = torch.randint(0, 256, xu.shape, generator=gen, device="cuda",
                       dtype=torch.int32)  # full 8b codes
    planes = torch.cat([planes, torch.full_like(planes[:1], 7)])
    valid = torch.tensor([True, True, True, False], device="cuda")
    shifts = torch.tensor([4, 2, 0, 6], dtype=torch.int32, device="cuda")
    for slicing in (SPEC, (8,)):
        tables = ops.crossbar_tables(planes, shifts, slicing, valid)
        for bits in (24, 7):
            adc = adc_lib.ADCConfig(bits=bits)
            kw = dict(adc_lo=adc.lo, adc_hi=adc.hi)
            got = fx.launch(xu, *tables, centers, **kw)
            row = compare("fused_crossbar", got,
                          fx.plain(xu, *tables, centers, **kw), site="qkvo",
                          B=4, R=R, C=C, adc_bits=bits,
                          input_slicing="-".join(map(str, slicing)),
                          valid="1110", sats=int(got[1]))
            rows.append(row)
            say("kernels", **row)


# K1 tails (B, R, C, n_j, input slicing, padded last plane, wrapping
# centers), full 8b codes: C = 1000 and R = 1001 take the word-load path,
# C = 1008 the cp.async path with a ragged column tile; 1000, 1001 and 2816
# rows leave the last segment ragged; 8 planes give clusters of 8 ranks and
# B = 16 with 8 planes is Algorithm 1's widest candidate at a layer site;
# B = 1, 2 and 3 take batch tiles of 1, 2 and 4 rows
K1_TAILS = ((3, 1000, 1000, 3, ONE_BIT, False, False),
            (9, 2816, 1008, 3, SPEC, False, True),
            (17, 1000, 1008, 8, ONE_BIT, True, False),
            (65, 2816, 1000, 1, (8,), False, True),
            (2, 1001, 1008, 3, (2, 2, 2, 2), False, True),
            (5, 1024, 1024, 8, (8,), True, True),
            (16, 1024, 2816, 8, ONE_BIT, True, False),
            (1, 2816, 1024, 3, (2, 2, 2, 2), False, False))


def tail_inputs(B: int, R: int, C: int, n_j: int, padded: bool, wrap: bool,
                gen):
    """Planes of up to 8 slices (zero padding rows; the last plane zeroed
    with mults 0 when ``padded``), their shifts and valid mask, full 8b
    codes and centers (across the int32 range when ``wrap``)."""
    import torch
    n_seg = -(-R // 512)
    planes = torch.cat([
        torch.randint(-m, m + 1, (1, n_seg, 512, C), generator=gen,
                      device="cuda", dtype=torch.int8)
        for m in (15, 3, 3, 1, 7, 3, 1, 15)[:n_j]])
    planes[:, -1, R - 512 * (n_seg - 1):] = 0  # zero padding rows
    shifts = torch.tensor([4, 2, 0, 6, 1, 3, 5, 7][:n_j],
                          dtype=torch.int32, device="cuda")
    valid = None
    if padded:  # the last plane pads a ragged plan: zeroed, mults 0
        valid = torch.ones(n_j, dtype=torch.bool, device="cuda")
        valid[-1] = False
    xu = torch.randint(0, 256, (B, R), generator=gen, device="cuda",
                       dtype=torch.int32)
    lo_hi = (-2**31, 2**31 - 1) if wrap else (1, 256)
    centers = torch.randint(*lo_hi, (n_seg, C), generator=gen,
                            device="cuda", dtype=torch.int32)
    return xu, planes, shifts, valid, centers


def check_k1_tails(rows: list, gen) -> None:
    """K1 past the site shapes (``K1_TAILS``) at 24b, timed, and at 7b,
    where it must saturate."""
    from repro_torch.core import adc as adc_lib
    from repro_torch.kernels import fused_crossbar as fx
    from repro_torch.kernels import ops
    for B, R, C, n_j, slicing, padded, wrap in K1_TAILS:
        xu, planes, shifts, valid, centers = tail_inputs(B, R, C, n_j, padded,
                                                         wrap, gen)
        tables = ops.crossbar_tables(planes, shifts, slicing, valid)
        for bits in (24, 7):
            adc = adc_lib.ADCConfig(bits=bits)
            kw = dict(adc_lo=adc.lo, adc_hi=adc.hi)
            got = fx.launch(xu, *tables, centers, **kw)
            row = compare("fused_crossbar", got,
                          fx.plain(xu, *tables, centers, **kw), site="tail",
                          B=B, R=R, C=C, n_j=n_j, adc_bits=bits,
                          input_slicing="-".join(map(str, slicing)),
                          padded=padded, wrap=wrap, sats=int(got[1]))
            if bits == 24:
                row["tail_ms"] = cuda_ms(
                    lambda: fx.launch(xu, *tables, centers, **kw), 3)
            elif int(got[1]) == 0:
                raise AssertionError(f"K1 tail {row} had no saturations")
            rows.append(row)
            say("kernels", **row)
        del xu, planes, centers, tables


def check_interleaved(rows: list, gen) -> None:
    """K4, K1, K4, K2, K1, K4 launched back to back on one stream at the
    7b ADC, read only after all six: each kernel's result and K1's and K2's
    counters equal the plain version's, so neither of those adds into the
    other's counts buffer, and K4, which keeps no counters, leaves both
    chains alone."""
    import torch
    from repro_torch.core import adc as adc_lib
    from repro_torch.kernels import fused_crossbar as fx
    from repro_torch.kernels import fused_spec_crossbar as fs
    from repro_torch.kernels import ops
    from repro_torch.kernels import sliced_crossbar as sx
    R, C = SITE_SHAPES["qkvo"]
    adc = adc_lib.ADCConfig(bits=7)
    kw = dict(adc_lo=adc.lo, adc_hi=adc.hi)
    calls = []
    for kernel in ("sliced_crossbar", "fused_crossbar", "sliced_crossbar",
                   "fused_spec_crossbar", "fused_crossbar",
                   "sliced_crossbar"):
        if kernel == "sliced_crossbar":
            calls.append((kernel, sx, k4_full_inputs(8, 3, 4, R, C, gen)))
            continue
        xu, planes, shifts, valid, centers = tail_inputs(4, R, C, 3, False,
                                                         False, gen)
        if kernel == "fused_crossbar":
            calls.append((kernel, fx, (xu, *ops.crossbar_tables(
                planes, shifts, ONE_BIT), centers)))
        else:
            calls.append((kernel, fs, (xu, *ops.spec_tables(
                planes, shifts, SPEC), centers)))
    got = [mod.launch(*args, **kw) for _, mod, args in calls]
    torch.cuda.synchronize()
    for (kernel, mod, args), g in zip(calls, got):
        counted = kernel != "sliced_crossbar"
        counts = {} if not counted else dict(counts=json.dumps(
            [int(t) for t in g[1:]] if kernel == "fused_crossbar"
            else g[1].tolist() + [int(g[2])]))
        row = compare(kernel, g, mod.plain(*args, **kw), site="interleaved",
                      B=4, R=R, C=C, adc_bits=7, **counts)
        if counted and not int(g[1].sum()) > 0:
            raise AssertionError(f"interleaved {kernel} counted nothing")
        rows.append(row)
        say("kernels", **row)


def k4_full_inputs(n_i: int, n_j: int, B: int, R: int, C: int, gen):
    """int8 slices and planes over -128..127 (every 5th x row and every
    7th plane row -128) and mults over +-2**20, which wrap the int32
    result at the 24b ADC."""
    import torch
    xs = torch.randint(-128, 128, (n_i, B, R), generator=gen, device="cuda",
                       dtype=torch.int8)
    xs[:, :, ::5] = -128
    planes = torch.randint(-128, 128, (n_j, R, C), generator=gen,
                           device="cuda", dtype=torch.int8)
    planes[:, ::7] = -128
    mults = torch.randint(-2**20, 2**20, (n_i, n_j), generator=gen,
                          device="cuda", dtype=torch.int32)
    return xs, planes, mults


def k4_inputs(B: int, R: int, C: int, gen):
    """8 one-bit slices of unsigned codes (0..127) and (4,2,2)-range
    planes with their recombination multipliers 2**(l_i + l_j)."""
    import torch
    x = torch.randint(0, 128, (B, R), generator=gen, device="cuda")
    xs = torch.stack([(x >> (7 - i)) & 1 for i in range(8)]).to(torch.int8)
    planes = torch.stack([
        torch.randint(-m, m + 1, (R, C), generator=gen, device="cuda",
                      dtype=torch.int8) for m in (15, 3, 3)])
    mults = torch.tensor([[1 << (7 - i + lj) for lj in (4, 2, 0)]
                          for i in range(8)], dtype=torch.int32,
                         device="cuda")
    return xs.contiguous(), planes, mults


# K4 tails (n_i, n_j, B, R, C), int8 values -128..127 on both sides: R =
# 1, 7, 1001 or C = 7, 1000 take the word-load path, R = 1024 with C =
# 1008 the cp.async path with a ragged column tile; R = 7, 1001 and 2816
# end in a partial segment; one slice and one plane give a cluster of 1
# rank, 8 planes clusters of 8; B = 1, 2 and 3 take batch tiles of 1, 2
# and 4 rows; the head's shape at B = 4
K4_TAILS = ((1, 1, 1, 1, 7), (3, 3, 3, 7, 1008), (8, 8, 17, 1024, 1008),
            (3, 8, 4, 1001, 7), (8, 3, 64, 1024, 1024),
            (1, 3, 2, 2816, 1000), (8, 1, 16, 1024, 2816),
            (3, 1, 65, 1001, 1008), (8, 3, 4, 1024, 151936))


def check_k4(rows: list, gen) -> None:
    """K4 at the four site shapes (8 one-bit slices, 3 planes) at B = 1, 4,
    16 and 64, timed at B = 4, and at ``K4_TAILS``; at 24b and 7b, where
    the clamps must bite (the 7b result differs from the 24b one)."""
    import torch
    from repro_torch.core import adc as adc_lib
    from repro_torch.kernels import sliced_crossbar as sx
    cases = [(site, B, k4_inputs, (B, R, C))
             for site, (R, C) in SITE_SHAPES.items() for B in K1_BATCHES]
    cases += [("tail", case[2], k4_full_inputs, case) for case in K4_TAILS]
    for site, B, make, shape in cases:
        args = make(*shape, gen)
        (n_i, _, R), (n_j, _, C) = args[0].shape, args[1].shape
        outs = {}
        for bits in (24, 7):
            adc = adc_lib.ADCConfig(bits=bits)
            kw = dict(adc_lo=adc.lo, adc_hi=adc.hi)
            outs[bits] = sx.launch(*args, **kw)
            row = compare("sliced_crossbar", outs[bits],
                          sx.plain(*args, **kw), site=site, B=B, R=R, C=C,
                          adc_bits=bits, n_i=n_i, n_j=n_j)
            if bits == 24 and site != "tail" and B == 4:
                row["kernel_ms"] = cuda_ms(lambda: sx.launch(*args, **kw), 5)
                row["plain_ms"] = cuda_ms(lambda: sx.plain(*args, **kw), 1)
            elif bits == 7 and torch.equal(outs[7], outs[24]):
                raise AssertionError(f"K4 {row} did not clamp at 7b")
            rows.append(row)
            say("kernels", **row)
        del args, outs


def serve_requests(vocab: int):
    """4 requests, prompts of 8..16 tokens, 8 new tokens each (seeded)."""
    import numpy as np
    from repro_torch.serve import Request
    rng = np.random.default_rng(1)
    return [Request(uid=u, prompt=rng.integers(0, vocab, int(n)).astype(
        np.int32), max_new_tokens=8) for u, n in enumerate(
            rng.integers(8, 17, 4))]


def phase_serve(ctx: dict) -> None:
    """Serve qwen1.5-0.5b at full width in exact, int8 and fast mode, then
    exact with speculation off on the pinned exact plans, then exact with
    Algorithm 1's adaptive per-site plans."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import calibration_tokens
    from repro_torch.models import layers as L
    from repro_torch.models import pim
    from repro_torch.models import transformer as T
    from repro_torch.serve import ContinuousServeEngine
    cfg0 = configs.get(ARCH)
    t0 = time.perf_counter()
    params = T.init_params(cfg0, seed=0, device="cuda")
    torch.cuda.synchronize()
    say("serve", arch=ARCH, layers=cfg0.n_layers, d_model=cfg0.d_model,
        vocab=cfg0.vocab_size, dtype=cfg0.dtype,
        init_s=round(time.perf_counter() - t0, 3))
    reqs = serve_requests(cfg0.vocab_size)
    # a whole number of blocks, so that the paged runs and the contiguous
    # runs attend over one length (the condition of _paged_gather's
    # bit-identity argument)
    max_len = BLOCK * -(-(max(len(r.prompt) for r in reqs) + 8 + 1) // BLOCK)
    calib = calibration_tokens(cfg0, 16)
    runs = (("exact", dict(pim_mode="exact")),
            ("int8", dict(pim_mode="int8")),
            ("fast", dict(pim_mode="fast")),
            ("exact-nospec", dict(pim_mode="exact", pim_speculation=False)),
            ("exact-adaptive", dict(pim_mode="exact",
                                    pim_weight_slicing="adaptive")))
    tokens, totals = {}, {}
    for run, over in runs:
        cfg = dataclasses.replace(cfg0, **over)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        if run == "exact-nospec":  # the pinned exact plans, speculation off
            compiled = ctx["exact_compiled"]
        else:
            compiled = pim.compile_pim_params(params, cfg, calib)
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
        compile_launches = ops.launch_counts()
        eng = ContinuousServeEngine(cfg, params, n_slots=N_SLOTS,
                                    max_len=max_len,
                                    prefill_chunk=64, plans=compiled.plans)
        t0 = time.perf_counter()
        with L.collect_pim_stats() as sink, step_timer(eng):
            outs = eng.run(reqs)
            torch.cuda.synchronize()
            serve_s = time.perf_counter() - t0
            launches = ops.launch_counts()
            totals[run] = L.pim_stats_totals(sink)
        assert len(outs) == len(reqs)
        served = {k: launches[k] - compile_launches[k] for k in launches}
        tokens[run] = [o.tokens.tolist() for o in outs]
        row = engine_row(run, eng, outs, serve_s, launches, PER_CALL[run],
                         cfg0.vocab_size, served=served)
        row["compile_s"] = round(compile_s, 3)
        n_tok = row["tokens"]
        if run.startswith("exact"):
            tot = totals[run]
            row.update(adc_converts_per_token=tot["adc_converts"] / n_tok,
                       no_spec_converts_per_token=tot["no_spec_converts"]
                       / n_tok, spec_failures=tot["spec_failures"])
        if run == "exact":
            ctx["k2_launches"] = served["fused_spec_crossbar"]
            ctx["exact_compiled"] = compiled
        elif run == "fast":
            ctx["k3_launches"] = served["centered_int8_matmul"]
            ctx["fast_plans"] = compiled.plans
        elif run == "exact-nospec":
            # both count B * n_seg * C * 8 * n_j converts per pass
            assert tot["adc_converts"] == totals["exact"]["no_spec_converts"]
        elif run == "exact-adaptive":
            adaptive_cfg = cfg
            ctx["adaptive_plans"] = compiled.plans
            errs = [sp.error for sp in compiled.sites]
            ctx["k1_launches"] = launches["fused_crossbar"]
            ctx["adaptive_compile_s"] = compile_s
            row.update(
                search_k1_launches=compile_launches["fused_crossbar"],
                slice_histogram=json.dumps(compiled.slice_histogram()),
                distinct_slicings=json.dumps(
                    ["-".join(map(str, sl))
                     for sl in compiled.distinct_slicings()]),
                mean_site_error=sum(errs) / len(errs),
                max_site_error=max(errs))
            assert compile_launches["fused_crossbar"] > 0
        say("serve", **row)
        del compiled, eng
    ctx["k1_compile"] = k1_compile_device_time(params, adaptive_cfg, calib)
    say("serve", scope="Algorithm 1 compile again, under torch.profiler",
        **ctx["k1_compile"])
    sampled = check_sampling(dataclasses.replace(cfg0, pim_mode="exact"),
                             params, ctx["exact_compiled"].plans,
                             reqs[0].prompt)
    say("serve", **sampled)
    for run in ("exact", "exact-nospec", "exact-adaptive"):
        if tokens[run] != tokens["int8"]:
            raise AssertionError(
                f"{run} tokens differ from int8 tokens at the 24b ADC: "
                f"{tokens[run]} vs {tokens['int8']}")
    serve_paged(ctx, params, cfg0, reqs, tokens, max_len)
    say("serve", ok=True, exact_equals_int8=True,
        first_tokens=json.dumps(tokens["exact"][0]))
    # the telemetry phase serves the same model, requests and plans
    ctx["qwen"] = dict(cfg=cfg0, params=params, reqs=reqs, max_len=max_len,
                       tokens=tokens)


def empty_experts(cfg, plans: dict) -> int:
    """Expert instances whose calibration buffer held no token: x_scale
    at the 1e-12 floor (``quant.calibrate_layer``)."""
    import torch
    from repro_torch.models import layers as L
    floor = torch.tensor(1e-12, dtype=torch.float32)
    return sum(int((leaf["x_scale"].cpu() == floor).sum())
               for layer, lp in enumerate(plans["layers"])
               if L.is_moe_layer(cfg, layer) for leaf in lp["ffn"].values())


def peak_gb(base: int = 0) -> float:
    """Peak allocated GiB since the last reset, less ``base`` bytes (what
    earlier phases keep resident)."""
    import torch
    return round((torch.cuda.max_memory_allocated() - base) / 2**30, 3)


def n_params_of(tree) -> int:
    """Elements of every tensor in a nested dict of parameters."""
    import torch
    if isinstance(tree, torch.Tensor):
        return tree.numel()
    if isinstance(tree, dict):
        return sum(n_params_of(v) for v in tree.values())
    return sum(n_params_of(v) for v in tree)


def phase_moe(ctx: dict, rows: list) -> None:
    """Serve phi3.5-moe-42b (published widths, MOE_LAYERS layers, random
    bf16 weights from seed 0) through ``ContinuousServeEngine``: exact
    (K2 per expert), int8, fast (K3 per expert) and exact with Algorithm 1
    per (layer, expert) through K1; launch counts per engine call from the
    plans, exact == int8 == exact-adaptive tokens. At capacity DROP_FREE_CF
    (no slot can drop): fast through the lockstep, continuous and paged
    engines, tokens equal, and exact on a pool that must evict, equal to
    the continuous exact tokens. Each plan set is freed before the next
    compile. While plans are alive, one decode step's K2 calls (pinned
    and Algorithm 1's plans) and K3 calls are held bit for bit against
    the plain versions (rows in ``rows``) and timed (printed by the
    timing phase), and K1 runs Algorithm 1's search shape (SEARCH_ROWS
    rows, 1b input slices) on expert matrices of each slice count."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.kernels import fused_spec_crossbar as fs
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import calibration_tokens
    from repro_torch.models import layers as L
    from repro_torch.models import pim
    from repro_torch.models import transformer as T
    from repro_torch.serve import (ContinuousServeEngine, PagedServeEngine,
                                   ServeEngine)
    cfg0 = dataclasses.replace(configs.get(MOE_ARCH), n_layers=MOE_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg0, seed=0, device="cuda")
    torch.cuda.synchronize()
    say("moe", arch=MOE_ARCH, layers=cfg0.n_layers,
        reduced=f"n_layers {configs.get(MOE_ARCH).n_layers} -> "
        f"{cfg0.n_layers}", d_model=cfg0.d_model, n_heads=cfg0.n_heads,
        n_kv_heads=cfg0.n_kv_heads, d_ff=cfg0.d_ff,
        n_experts=cfg0.n_experts, top_k=cfg0.experts_per_token,
        vocab=cfg0.vocab_size, capacity_factor=cfg0.capacity_factor,
        dtype=cfg0.dtype, params=n_params_of(params),
        init_s=round(time.perf_counter() - t0, 3), peak_gb=peak_gb())
    reqs = serve_requests(cfg0.vocab_size)
    max_len = BLOCK * -(-(max(len(r.prompt) for r in reqs) + 8 + 1) // BLOCK)
    calib = calibration_tokens(cfg0, 16)
    gen = torch.Generator(device="cuda").manual_seed(2)
    kw = dict(n_slots=N_SLOTS, max_len=max_len, prefill_chunk=64)
    tokens: dict = {}

    def compile_plans(cfg):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        compiled = pim.compile_pim_params(params, cfg, calib)
        torch.cuda.synchronize()
        info = dict(compile_s=round(time.perf_counter() - t0, 3),
                    compile_launches=json.dumps(ops.launch_counts()),
                    sites=len(compiled.sites),
                    empty_expert_instances=empty_experts(cfg, compiled.plans),
                    compile_peak_gb=peak_gb())
        return compiled, info

    def serve(run, cfg, plans, engine=ContinuousServeEngine, **extra):
        eng = engine(cfg, params, plans=plans, **dict(kw, **extra))
        with L.collect_pim_stats() as sink:
            outs, serve_s, launches = drive(eng, reqs)
            totals = L.pim_stats_totals(sink)
        row = engine_row(run, eng, outs, serve_s, launches,
                         PER_CALL[cfg.pim_mode], cfg.vocab_size)
        row.update(peak_gb=peak_gb(), projections_per_call=len(
            step_calls(cfg, plans)))
        if cfg.pim_mode == "exact":
            n_tok = row["tokens"]
            row.update(adc_converts_per_token=totals["adc_converts"] / n_tok,
                       spec_failures=totals["spec_failures"])
        tokens[run] = [o.tokens.tolist() for o in outs]
        return eng, row

    # exact, pinned (4,2,2): K2 per projection and expert
    exact = dataclasses.replace(cfg0, pim_mode="exact")
    compiled, info = compile_plans(exact)
    row = serve("moe-exact", exact, compiled.plans)[1]
    ctx["moe_k2_launches"] = json.loads(row["launches"])[
        "fused_spec_crossbar"]
    say("moe", **row, **info)
    ctx["moe_rows"] = L.moe_dispatch_rows(exact, N_SLOTS, 1)
    step = f"{MOE_ARCH} decode step"
    k2_calls, k2_bytes, k2_ops = kernel_calls(
        "fused_spec_crossbar", exact, compiled.plans, gen)[:3]
    kw24 = dict(adc_lo=-(1 << 23), adc_hi=(1 << 23) - 1)
    say("moe", **check_step(rows, "fused_spec_crossbar", fs.launch, fs.plain,
                            k2_calls, step, **kw24))
    ctx["moe_k2"] = dict(
        ms=cuda_ms(lambda: [fs.launch(*a, **kw24) for _, a in k2_calls], 3),
        plain_ms=cuda_ms(lambda: [fs.plain(*a, **kw24)
                                  for _, a in k2_calls], 1, warmup=0),
        library_ms=None, calls=len(k2_calls), **bound(k2_bytes, k2_ops))
    del k2_calls
    # capacity DROP_FREE_CF, exact: continuous, then paged on 5 blocks
    exact8 = dataclasses.replace(exact, capacity_factor=DROP_FREE_CF)
    row = serve("moe-exact-cf8", exact8, compiled.plans)[1]
    say("moe", **row)
    eng, row = serve("paged-moe-exact", exact8, compiled.plans,
                     engine=PagedServeEngine, block_size=BLOCK, n_blocks=5)
    if not (eng.stats.evictions >= 1 and eng.stats.blocks_in_use == 0):
        raise AssertionError(f"paged-moe-exact: {eng.stats}")
    if tokens["paged-moe-exact"] != tokens["moe-exact-cf8"]:
        raise AssertionError("paged-moe-exact tokens differ from the "
                             "continuous engine's at the same capacity")
    say("moe", **row, equals_continuous_exact=True)
    del compiled, eng
    # int8: the ideal 8b reference, no kernel
    int8 = dataclasses.replace(cfg0, pim_mode="int8")
    compiled, info = compile_plans(int8)
    row = serve("moe-int8", int8, compiled.plans)[1]
    say("moe", **row, **info)
    del compiled
    if tokens["moe-exact"] != tokens["moe-int8"]:
        raise AssertionError("moe-exact tokens differ from moe-int8 tokens "
                             "at the 24b ADC")
    # fast: K3 per projection and expert; then the three engines at
    # capacity DROP_FREE_CF
    fast = dataclasses.replace(cfg0, pim_mode="fast")
    compiled, info = compile_plans(fast)
    row = serve("moe-fast", fast, compiled.plans)[1]
    ctx["moe_k3_launches"] = json.loads(row["launches"])[
        "centered_int8_matmul"]
    say("moe", **row, **info)
    ctx["moe_k3"] = k3_step(fast, compiled.plans, gen, rows, step,
                            "moe")[1]
    fast8 = dataclasses.replace(fast, capacity_factor=DROP_FREE_CF)
    row = serve("moe-fast-cf8", fast8, compiled.plans)[1]
    say("moe", **row)
    row = serve("paged-moe-fast", fast8, compiled.plans,
                engine=PagedServeEngine, block_size=BLOCK)[1]
    say("moe", **row)
    ops.reset_launch_counts()
    lock = ServeEngine(fast8, params, max_len=max_len, plans=compiled.plans)
    t0 = time.perf_counter()
    lock_tokens = [lock.generate(r.prompt[None], steps=r.max_new_tokens)
                   .tokens[0].tolist() for r in reqs]
    torch.cuda.synchronize()
    lock_launches = ops.launch_counts()
    calls = sum(r.max_new_tokens for r in reqs)  # prefill + 7 decodes each
    want = len(step_calls(fast8, compiled.plans)) * calls
    if lock_launches["centered_int8_matmul"] != want:
        raise AssertionError(f"lockstep launches {lock_launches}, want K3 "
                             f"{want}")
    if not (lock_tokens == tokens["moe-fast-cf8"]
            == tokens["paged-moe-fast"]):
        raise AssertionError(
            f"capacity {DROP_FREE_CF}: lockstep {lock_tokens}, continuous "
            f"{tokens['moe-fast-cf8']}, paged {tokens['paged-moe-fast']}")
    say("moe", mode="lockstep-moe-fast-cf8", engine="ServeEngine",
        serve_s=round(time.perf_counter() - t0, 3), engine_calls=calls,
        launches=json.dumps(lock_launches),
        lockstep_equals_continuous_equals_paged=True)
    del compiled, lock
    # exact with Algorithm 1 per (layer, expert) through K1, then K2
    adaptive = dataclasses.replace(exact, pim_weight_slicing="adaptive")
    compiled, info = compile_plans(adaptive)
    search = json.loads(info["compile_launches"])["fused_crossbar"]
    errs = [sp.error for sp in compiled.sites]
    row = serve("moe-exact-adaptive", adaptive, compiled.plans)[1]
    ctx["moe_k1_launches"] = search
    say("moe", **row, **info, search_k1_launches=search,
        slice_histogram=json.dumps(compiled.slice_histogram()),
        distinct_slicings=json.dumps(["-".join(map(str, sl)) for sl in
                                      compiled.distinct_slicings()]),
        mean_site_error=sum(errs) / len(errs), max_site_error=max(errs))
    if search <= 0:
        raise AssertionError("Algorithm 1's compile launched no K1")
    ka_calls = kernel_calls("fused_spec_crossbar", adaptive,
                            compiled.plans, gen)[0]
    say("moe", **check_step(rows, "fused_spec_crossbar", fs.launch, fs.plain,
                            ka_calls, f"{step}, Algorithm 1's plans", **kw24))
    del ka_calls
    check_k1_search("moe", adaptive, expert_search_leaves(compiled.plans),
                    rows, gen)
    del compiled
    if tokens["moe-exact-adaptive"] != tokens["moe-int8"]:
        raise AssertionError("moe-exact-adaptive tokens differ from "
                             "moe-int8 tokens at the 24b ADC")
    mine = [r for r in rows
            if str(r.get("site", "")).startswith(MOE_ARCH)]
    say("moe", ok=True, exact_equals_int8=True,
        exact_adaptive_equals_int8=True, kernel_checks=len(mine),
        kernel_checks_max_abs_err=max(r["max_abs_err"] for r in mine),
        first_tokens=json.dumps(tokens["moe-exact"][0]))
    del params
    torch.cuda.empty_cache()


def phase_hybrid(ctx: dict, rows: list) -> None:
    """The recurrent blocks: rwkv6-3b whole at its published size through
    every engine, one jamba-1.5-large-398b layer at its published widths,
    and jamba-1.5-large-398b whole at ``reduced()`` widths."""
    hybrid_rwkv(ctx, rows)
    hybrid_jamba_layer(ctx, rows)
    hybrid_jamba_reduced(rows)


def hybrid_rwkv(ctx: dict, rows: list) -> None:
    """Serve rwkv6-3b (all 32 layers at published widths, random bf16
    weights from seed 0; only the LM head is a crossbar site) through
    ``ContinuousServeEngine`` in exact (K2), int8, fast (K3), exact with
    speculation off (K1) and exact with Algorithm 1 on the head (K1 at
    compile time): launches per engine call from the plans, exact == int8
    == exact-nospec == exact-adaptive tokens. Then exact mode through the
    lockstep engine (each request alone) and the paged engine (staged B=1
    prefill on 5 blocks: it must evict, and the victim prefills again),
    tokens equal to the continuous engine's; a sampled request; every K2,
    K1 and K3 call of one decode step held bit for bit against the plain
    versions."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.kernels import fused_crossbar as fx
    from repro_torch.kernels import fused_spec_crossbar as fs
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import calibration_tokens
    from repro_torch.models import layers as L
    from repro_torch.models import pim
    from repro_torch.models import transformer as T
    from repro_torch.serve import ContinuousServeEngine, PagedServeEngine
    cfg0 = configs.get(RWKV_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg0, seed=0, device="cuda")
    torch.cuda.synchronize()
    say("hybrid", arch=RWKV_ARCH, layers=cfg0.n_layers,
        d_model=cfg0.d_model, d_ff=cfg0.d_ff, vocab=cfg0.vocab_size,
        head_dim=cfg0.rwkv_head_dim, dtype=cfg0.dtype,
        params=n_params_of(params), init_s=round(time.perf_counter() - t0, 3),
        peak_gb=peak_gb())
    reqs = serve_requests(cfg0.vocab_size)
    max_len = BLOCK * -(-(max(len(r.prompt) for r in reqs) + 8 + 1) // BLOCK)
    calib = calibration_tokens(cfg0, 16)
    kw = dict(n_slots=N_SLOTS, max_len=max_len, prefill_chunk=64)
    runs = (("rwkv-exact", dict(pim_mode="exact"), "exact"),
            ("rwkv-int8", dict(pim_mode="int8"), "int8"),
            ("rwkv-fast", dict(pim_mode="fast"), "fast"),
            ("rwkv-exact-nospec", dict(pim_mode="exact",
                                       pim_speculation=False),
             "exact-nospec"),
            ("rwkv-exact-adaptive", dict(pim_mode="exact",
                                         pim_weight_slicing="adaptive"),
             "exact-adaptive"))
    tokens, compiled, served = {}, {}, {}
    for run, over, per_call in runs:
        cfg = dataclasses.replace(cfg0, **over)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        if run == "rwkv-exact-nospec":  # the pinned exact plans
            comp = compiled["rwkv-exact"]
        else:
            comp = pim.compile_pim_params(params, cfg, calib)
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
        compile_launches = ops.launch_counts()
        compiled[run] = comp
        eng = ContinuousServeEngine(cfg, params, plans=comp.plans, **kw)
        with L.collect_pim_stats() as sink:
            outs, serve_s, served[run] = drive(eng, reqs)
            totals = L.pim_stats_totals(sink)
        row = engine_row(run, eng, outs, serve_s, served[run],
                         PER_CALL[per_call], cfg0.vocab_size)
        row.update(compile_s=round(compile_s, 3),
                   compile_launches=json.dumps(compile_launches),
                   sites=len(comp.sites),
                   head_slicing="-".join(map(str, comp.sites[-1].slicing)),
                   peak_gb=peak_gb())
        if cfg.pim_mode == "exact":
            row.update(adc_converts_per_token=totals["adc_converts"]
                       / row["tokens"])
        if run == "rwkv-exact-adaptive":
            if compile_launches["fused_crossbar"] <= 0:
                raise AssertionError("Algorithm 1's compile launched no K1")
            ctx["hybrid_k1_search_launches"] = compile_launches[
                "fused_crossbar"]
        tokens[run] = [o.tokens.tolist() for o in outs]
        say("hybrid", **row)
        del eng
    ctx["hybrid_launches"] = {
        "fused_spec_crossbar": served["rwkv-exact"]["fused_spec_crossbar"],
        "centered_int8_matmul": served["rwkv-fast"]["centered_int8_matmul"],
        "fused_crossbar": served["rwkv-exact-nospec"]["fused_crossbar"]}
    for run in ("rwkv-exact", "rwkv-exact-nospec", "rwkv-exact-adaptive"):
        if tokens[run] != tokens["rwkv-int8"]:
            raise AssertionError(f"{run} tokens differ from rwkv-int8 tokens "
                                 f"at the 24b ADC: {tokens[run]} vs "
                                 f"{tokens['rwkv-int8']}")
    exact = dataclasses.replace(cfg0, pim_mode="exact")
    plans = compiled["rwkv-exact"].plans
    # the paged engine, staged prefill on 5 blocks (the requests need 8)
    eng = PagedServeEngine(exact, params, plans=plans, block_size=BLOCK,
                           n_blocks=5, **kw)
    outs, serve_s, launches = drive(eng, reqs)
    row = engine_row("paged-rwkv-exact", eng, outs, serve_s, launches,
                     PER_CALL["exact"], cfg0.vocab_size)
    if not (eng.staged_prefill and eng.stats.evictions >= 1
            and eng.stats.blocks_in_use == 0
            and eng.stats.prefill_chunks > len(reqs)):
        raise AssertionError(f"paged-rwkv-exact: {eng.stats}")
    paged = [o.tokens.tolist() for o in outs]
    say("hybrid", **row, staged_prefill=True)
    lock_tokens, lock = lockstep_exact("lockstep-rwkv-exact", exact, params,
                                       plans, reqs, max_len)
    if not lock_tokens == tokens["rwkv-exact"] == paged:
        raise AssertionError(
            f"lockstep {lock_tokens}, continuous {tokens['rwkv-exact']}, "
            f"paged {paged}")
    say("hybrid", lockstep_equals_continuous_equals_paged=True)
    say("hybrid", **check_sampling(exact, params, plans, reqs[0].prompt))
    say("hybrid", scope="rwkv-exact again, under torch.profiler",
        **device_profile(ContinuousServeEngine(exact, params, plans=plans,
                                               **kw), reqs))
    # one decode step's kernel calls, each against its plain version
    gen = torch.Generator(device="cuda").manual_seed(4)
    tag = f"{RWKV_ARCH} decode step"
    kw24 = dict(adc_lo=-(1 << 23), adc_hi=(1 << 23) - 1)
    k2_calls = kernel_calls("fused_spec_crossbar", exact, plans, gen)[0]
    say("hybrid", **check_step(rows, "fused_spec_crossbar", fs.launch,
                               fs.plain, k2_calls, tag, **kw24))
    k1_calls = kernel_calls("fused_crossbar", exact, plans, gen,
                            slicing=ONE_BIT)[0]
    say("hybrid", **check_step(rows, "fused_crossbar", fx.launch, fx.plain,
                               k1_calls, f"{tag}, speculation off", **kw24))
    k3_step(dataclasses.replace(cfg0, pim_mode="fast"),
            compiled["rwkv-fast"].plans, gen, rows, tag, "hybrid")
    del compiled, eng, lock, params, k2_calls, k1_calls
    torch.cuda.empty_cache()
    say("hybrid", ok=True, arch=RWKV_ARCH, exact_equals_int8=True,
        first_tokens=json.dumps(tokens["rwkv-exact"][0]))


def hybrid_jamba_layer(ctx: dict, rows: list) -> None:
    """One jamba-1.5-large-398b layer at its published widths (pattern
    position JAMBA_LAYER: the mamba mixer and a dense FFN, random bf16
    weights from seed 0) through the port's ``run_layer``: each of the 4
    requests' prompt prefilled at B=1 from a zero carry (random bf16
    hidden states stand for the layer's input), the carries spliced into
    N_SLOTS slots, then JAMBA_DECODES decode steps. On the pinned exact
    (K2), int8, fast (K3) and Algorithm 1's plans (K1 in the compile,
    then K2), launches counted from the plans; the exact, int8 and
    adaptive outputs equal. Every K2 and K3 call of one decode step and
    K1 at Algorithm 1's search shape on each matrix, held bit for bit
    against the plain versions and timed."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.kernels import fused_spec_crossbar as fs
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.models import pim_compile as pc
    from repro_torch.models import ssm as S
    from repro_torch.models import transformer as T
    cfg0 = configs.get(JAMBA_ARCH)
    if not (T.block_kind(cfg0, JAMBA_LAYER) == "mamba"
            and not L.is_moe_layer(cfg0, JAMBA_LAYER)):
        raise AssertionError(f"{JAMBA_ARCH} layer {JAMBA_LAYER} is not a "
                             "mamba layer with a dense FFN")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bp = T.init_layer(cfg0, JAMBA_LAYER, seed=0, device="cuda")
    torch.cuda.synchronize()
    di, dtr, ds, conv = S.mamba_dims(cfg0)
    shapes = {f"{g}.{n}": list(w.shape) for g in ("core", "ffn")
              for n, w in bp[g].items() if n in ("in_proj", "x_proj",
                                                 "out_proj", "w1", "w3",
                                                 "w2")}
    say("hybrid", arch=JAMBA_ARCH, layer=JAMBA_LAYER,
        kind=T.block_kind(cfg0, JAMBA_LAYER),
        reduced=f"one layer of {cfg0.n_layers}", d_model=cfg0.d_model,
        d_inner=di, d_state=ds, conv=conv, dt_rank=dtr, d_ff=cfg0.d_ff,
        dtype=cfg0.dtype, params=n_params_of(bp), shapes=json.dumps(shapes),
        init_s=round(time.perf_counter() - t0, 3), peak_gb=peak_gb())
    gen = torch.Generator(device="cuda").manual_seed(5)
    dt = getattr(torch, cfg0.dtype)

    def hidden(*shape):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(dt)
    x_cal = hidden(2, 16, cfg0.d_model)  # calibration_tokens' (2, 16)
    prompts = [hidden(1, len(r.prompt), cfg0.d_model)
               for r in serve_requests(cfg0.vocab_size)]
    steps = [hidden(N_SLOTS, 1, cfg0.d_model) for _ in range(JAMBA_DECODES)]

    @torch.no_grad()
    def drive_layer(cfg, plan):
        """The layer's outputs (prefills, then decode steps) and its K1,
        K2 and K3 launches."""
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state = S.init_mamba_state(cfg, N_SLOTS, "cuda")
        outs = []
        for slot, x in enumerate(prompts):
            one = S.init_mamba_state(cfg, 1, "cuda")
            outs.append(T.run_layer(bp, cfg, JAMBA_LAYER, x, one, plan, None))
            for k in state:
                state[k][slot] = one[k][0]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for x in steps:
            outs.append(T.run_layer(bp, cfg, JAMBA_LAYER, x, state, plan,
                                    None))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return outs, ops.launch_counts(), dict(
            prefill_s=round(t1 - t0, 3),
            step_ms=round(1e3 * (t2 - t1) / len(steps), 2))

    calls = len(prompts) + len(steps)
    outs, plans, sites = {}, {}, {}
    for run, over, per_call in (
            ("jamba-layer-exact", dict(pim_mode="exact"), "exact"),
            ("jamba-layer-int8", dict(pim_mode="int8"), "int8"),
            ("jamba-layer-fast", dict(pim_mode="fast"), "fast"),
            ("jamba-layer-exact-adaptive",
             dict(pim_mode="exact", pim_weight_slicing="adaptive"),
             "exact-adaptive")):
        cfg = dataclasses.replace(cfg0, **over)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        comp = pc.compile_layer(bp, cfg, JAMBA_LAYER, x_cal)
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
        compile_launches = ops.launch_counts()
        outs[run], launches, times = drive_layer(cfg, comp.plans)
        n_proj = len(step_calls(cfg, {"layers": [None] * JAMBA_LAYER
                                      + [comp.plans]}))
        want = {k: PER_CALL[per_call].get(k, 0) * n_proj * calls
                for k in launches}
        if launches != want:
            raise AssertionError(f"{run}: launches {launches}, want {want}")
        say("hybrid", mode=run, compile_s=round(compile_s, 3),
            compile_launches=json.dumps(compile_launches),
            sites=len(comp.sites), slicings=json.dumps(
                {s.site: "-".join(map(str, s.slicing)) for s in comp.sites}),
            errors=json.dumps({s.site: s.error for s in comp.sites}),
            engine_calls=calls, projections_per_call=n_proj,
            launches=json.dumps(launches), peak_gb=peak_gb(), **times)
        if run == "jamba-layer-exact-adaptive":
            if compile_launches["fused_crossbar"] <= 0:
                raise AssertionError("Algorithm 1's compile launched no K1")
            ctx["jamba_k1_search_launches"] = compile_launches[
                "fused_crossbar"]
        if run != "jamba-layer-int8":
            plans[run] = comp.plans
        sites[run] = comp.sites
        del comp
    for run in ("jamba-layer-exact", "jamba-layer-exact-adaptive"):
        if not all(torch.equal(a, b) for a, b in zip(
                outs[run], outs["jamba-layer-int8"])):
            raise AssertionError(f"{run} outputs differ from int8's at the "
                                 "24b ADC")
    if not all(bool(torch.isfinite(o).all())
               for o in outs["jamba-layer-fast"]):
        raise AssertionError("jamba-layer-fast outputs are not finite")
    # one decode step's kernel calls (N_SLOTS rows, both passes in exact)
    one = {"layers": [None] * JAMBA_LAYER}
    tag = f"{JAMBA_ARCH} layer {JAMBA_LAYER} decode step"
    kw24 = dict(adc_lo=-(1 << 23), adc_hi=(1 << 23) - 1)
    exact = dataclasses.replace(cfg0, pim_mode="exact")
    k2_calls, k2_bytes, k2_ops = kernel_calls(
        "fused_spec_crossbar", exact,
        dict(one, layers=one["layers"] + [plans["jamba-layer-exact"]]),
        gen)[:3]
    say("hybrid", **check_step(rows, "fused_spec_crossbar", fs.launch,
                               fs.plain, k2_calls, tag, **kw24))
    ctx["jamba_k2"] = dict(
        ms=cuda_ms(lambda: [fs.launch(*a, **kw24) for _, a in k2_calls], 5),
        plain_ms=cuda_ms(lambda: [fs.plain(*a, **kw24)
                                  for _, a in k2_calls], 1, warmup=0),
        library_ms=None, calls=len(k2_calls), **bound(k2_bytes, k2_ops))
    del k2_calls
    ka_calls = kernel_calls(
        "fused_spec_crossbar", exact,
        dict(one, layers=one["layers"]
             + [plans["jamba-layer-exact-adaptive"]]), gen)[0]
    say("hybrid", **check_step(rows, "fused_spec_crossbar", fs.launch,
                               fs.plain, ka_calls,
                               f"{tag}, Algorithm 1's plans", **kw24))
    del ka_calls
    ctx["jamba_k3"] = k3_step(
        dataclasses.replace(cfg0, pim_mode="fast"),
        dict(one, layers=one["layers"] + [plans["jamba-layer-fast"]]),
        gen, rows, tag, "hybrid")[1]
    ctx["jamba_k1"] = check_k1_search(
        "hybrid", exact, [(f"{JAMBA_ARCH} search.{g}.{n}", leaf) for g, ls
                          in plans["jamba-layer-exact-adaptive"].items()
                          for n, leaf in ls.items()], rows, gen, timed=True)
    for name, d in (("fused_spec_crossbar", ctx["jamba_k2"]),
                    ("centered_int8_matmul", ctx["jamba_k3"]),
                    ("fused_crossbar", ctx["jamba_k1"])):
        say("hybrid", kernel=name, scope=f"{JAMBA_ARCH} layer {JAMBA_LAYER}"
            + (", Algorithm 1's search shape" if name == "fused_crossbar"
               else f", one decode step, B={N_SLOTS}"), **d)
    del plans, bp, outs
    torch.cuda.empty_cache()
    say("hybrid", ok=True, arch=JAMBA_ARCH, layer=JAMBA_LAYER,
        exact_equals_int8=True, exact_adaptive_equals_int8=True)


def lockstep_exact(run: str, cfg, params, plans: dict, reqs,
                   max_len: int):
    """Each request alone through the lockstep engine in exact mode: its
    tokens, with K2's launches checked against the plans' count (two
    signed passes per projection per engine call; a prefill and 7 decode
    steps per request). Returns (tokens, engine)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve import ServeEngine
    ops.reset_launch_counts()
    lock = ServeEngine(cfg, params, max_len=max_len, plans=plans)
    t0 = time.perf_counter()
    tokens = [lock.generate(r.prompt[None], steps=r.max_new_tokens)
              .tokens[0].tolist() for r in reqs]
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    calls = sum(r.max_new_tokens for r in reqs)
    want = 2 * len(step_calls(cfg, plans)) * calls
    if launches["fused_spec_crossbar"] != want:
        raise AssertionError(f"{run}: launches {launches}, want K2 {want}")
    say("hybrid", mode=run, engine="ServeEngine", serve_s=round(serve_s, 3),
        engine_calls=calls, launches=json.dumps(launches))
    return tokens, lock


def hybrid_jamba_reduced(rows: list) -> None:
    """jamba-1.5-large-398b whole at ``reduced()`` widths (its 8-layer
    pattern: mamba, attention and MoE layers; random bf16 weights from seed
    0): every K2 call of one decode step held bit for bit against the
    plain version at the shapes this model gives it (R = 64 and 128, one
    partial segment; C down to x_proj's 20); then exact mode through the lockstep (each
    request alone), continuous and paged engines (staged prefill on 5
    blocks, evicting), tokens equal, launches counted from the plans; and
    int8 mode through the continuous engine, tokens equal to exact's at
    the 24b ADC."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.kernels import fused_spec_crossbar as fs
    from repro_torch.launch.serve import calibration_tokens
    from repro_torch.models import pim
    from repro_torch.models import transformer as T
    from repro_torch.serve import ContinuousServeEngine, PagedServeEngine
    cfg0 = configs.get(JAMBA_ARCH).reduced()
    params = T.init_params(cfg0, seed=0, device="cuda")
    reqs = serve_requests(cfg0.vocab_size)
    max_len = BLOCK * -(-(max(len(r.prompt) for r in reqs) + 8 + 1) // BLOCK)
    calib = calibration_tokens(cfg0, 16)
    cfg = dataclasses.replace(cfg0, pim_mode="exact")
    t0 = time.perf_counter()
    comp = pim.compile_pim_params(params, cfg, calib)
    torch.cuda.synchronize()
    say("hybrid", arch=cfg.name, layers=cfg.n_layers,
        pattern="-".join(cfg.block_pattern), d_model=cfg.d_model,
        n_experts=cfg.n_experts, sites=len(comp.sites),
        compile_s=round(time.perf_counter() - t0, 3))
    gen = torch.Generator(device="cuda").manual_seed(6)
    say("hybrid", **check_step(
        rows, "fused_spec_crossbar", fs.launch, fs.plain,
        kernel_calls("fused_spec_crossbar", cfg, comp.plans, gen)[0],
        f"{cfg.name} decode step", adc_lo=-(1 << 23), adc_hi=(1 << 23) - 1))
    kw = dict(n_slots=N_SLOTS, max_len=max_len, prefill_chunk=64)
    int8 = dataclasses.replace(cfg0, pim_mode="int8")
    tokens = {}
    for run, eng, per_call in (
            ("reduced-jamba-exact",
             ContinuousServeEngine(cfg, params, plans=comp.plans, **kw),
             "exact"),
            ("paged-reduced-jamba-exact",
             PagedServeEngine(cfg, params, plans=comp.plans,
                              block_size=BLOCK, n_blocks=5, **kw), "exact"),
            ("reduced-jamba-int8",
             ContinuousServeEngine(int8, params, plans=pim.compile_pim_params(
                 params, int8, calib).plans, **kw), "int8")):
        outs, serve_s, launches = drive(eng, reqs)
        row = engine_row(run, eng, outs, serve_s, launches, PER_CALL[per_call],
                         cfg.vocab_size)
        tokens[run] = [o.tokens.tolist() for o in outs]
        say("hybrid", **row)
        if run.startswith("paged") and not (
                eng.staged_prefill and eng.stats.evictions >= 1
                and eng.stats.blocks_in_use == 0):
            raise AssertionError(f"{run}: {eng.stats}")
    lock_tokens, lock = lockstep_exact("lockstep-reduced-jamba-exact", cfg,
                                       params, comp.plans, reqs, max_len)
    if not (lock_tokens == tokens["reduced-jamba-exact"]
            == tokens["paged-reduced-jamba-exact"]):
        raise AssertionError(f"reduced jamba: lockstep {lock_tokens}, "
                             f"engines {tokens}")
    if tokens["reduced-jamba-exact"] != tokens["reduced-jamba-int8"]:
        raise AssertionError(f"reduced jamba: exact tokens differ from int8 "
                             f"at the 24b ADC: {tokens}")
    say("hybrid", ok=True, arch=cfg.name,
        lockstep_equals_continuous_equals_paged=True, exact_equals_int8=True,
        first_tokens=json.dumps(lock_tokens[0]))
    del params, comp, lock, eng


def encoder_inputs(cfg, B: int, S: int, gen):
    """(B, S) token ids, or (B, S, d_model) float32 frame embeddings for an
    embeddings-mode config, from ``gen`` on the card."""
    import torch
    if cfg.input_mode == "tokens":
        return torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                             device="cuda")
    return torch.randn((B, S, cfg.d_model), generator=gen, device="cuda")


def encoder_forward(params, cfg, x, plans) -> tuple:
    """One ``transformer.forward`` with every launch count zeroed just
    before and read just after: (logits, seconds, launches)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits = T.forward(params, cfg, x, plans)
    torch.cuda.synchronize()
    return logits, time.perf_counter() - t0, ops.launch_counts()


def kernel_calls(kernel: str, cfg, plans: dict, gen, rows: int | None = None,
                 slicing: tuple = SPEC) -> tuple:
    """The calls one engine call makes to ``kernel`` on compiled plans, in
    the model's order: a decode step (``rows`` None: N_SLOTS rows a
    projection, an expert its dispatch rows, as ``step_calls`` gives them)
    or a forward of ``rows`` rows a projection. K2
    (``fused_spec_crossbar``, spec ``slicing``) and K1
    (``fused_crossbar``, input ``slicing``) run twice a projection, one
    signed pass each on codes 0..127; K3 (``centered_int8_matmul``) once,
    on int8 codes. Each call reads its own layer's (and expert's) weights
    and a fresh random input, as a forward feeds each layer a new
    activation. Returns the ``(name, args)`` calls, the bytes and int8
    operations they need (operations over the true R rows: the compiler's
    zero padding to whole segments is read but computes nothing), and the
    first call of each distinct operand shape."""
    import torch
    from repro_torch.kernels import ops

    def x_for(B, R, dtype, lo):
        return torch.randint(lo, 128, (B, R), generator=gen, device="cuda",
                             dtype=dtype)
    calls, first, n_bytes, n_ops = [], {}, 0, 0
    for name, leaf, B in step_calls(cfg, plans):
        B = B if rows is None else rows
        if kernel == "centered_int8_matmul":
            R, C = leaf["w_off"].shape
            args = (x_for(B, R, torch.int8, -127), leaf["w_off"],
                    leaf["centers"])
            calls.append((name, args))
            first.setdefault((B, R, C), (name, args))
            n_bytes += B * R + R * C + 4 * C + 4 * B * C
            n_ops += 2 * B * R * C
            continue
        spec = kernel == "fused_spec_crossbar"
        n_i = len(slicing)
        n_j, n_seg, rx, C = leaf["planes"].shape
        R = leaf["w_q"].shape[0]
        tables = (ops.spec_tables if spec else ops.crossbar_tables)(
            leaf["planes"], leaf["slice_shifts"], slicing)
        for sign in "+-":
            args = (x_for(B, R, torch.int32, 0), *tables,
                    leaf["enc_centers"].contiguous())
            calls.append((f"{name}{sign}", args))
            first.setdefault((B, R, C, n_j), (f"{name}{sign}", args))
            n_bytes += (4 * B * R + n_j * n_seg * rx * C + 4 * n_i * n_j
                        + 4 * n_seg * C + 4 * B * C
                        + 8 * (n_i + 1 if spec else 1))  # int64 counters
            n_ops += 2 * B * R * C * n_j * n_i
    return calls, n_bytes, n_ops, list(first.values())


def engine_call_kernel(kernel: str, cfg, plans: dict, gen, rows: list,
                       tag: str, phase: str, n_rows: int | None = None
                       ) -> dict:
    """One engine call's calls of ``kernel`` on compiled plans, as
    ``kernel_calls`` gives them: a decode step (``n_rows`` None) or a
    forward of ``n_rows`` rows a projection. Held bit for bit against the
    plain version (psum and counters; rows in ``rows``): every call of a
    decode step, the first call of each distinct operand shape of a
    forward. Each distinct shape's first call is timed beside the plain
    version (whose float64 products take up to 10 GB at a wide head, so
    it runs once a shape), then every call back to back beside the bound
    and, for K3, ``torch._int_mm`` on the same x and weights."""
    import torch
    from repro_torch.kernels import fused_crossbar as fx
    from repro_torch.kernels import fused_spec_crossbar as fs
    from repro_torch.kernels import int8_matmul as im
    mod = {"fused_spec_crossbar": fs, "fused_crossbar": fx,
           "centered_int8_matmul": im}[kernel]
    kw = {} if mod is im else dict(adc_lo=-(1 << 23), adc_hi=(1 << 23) - 1)
    calls, n_bytes, n_ops, first = kernel_calls(
        kernel, cfg, plans, gen, n_rows, ONE_BIT if mod is fx else SPEC)
    checked = calls if n_rows is None else first
    summary = check_step(rows, kernel, mod.launch, mod.plain, checked, tag,
                         **kw)
    row_of = dict(zip((name for name, _ in checked), rows[-len(checked):]))
    for name, args in first:
        row = row_of[name]
        row["kernel_ms"] = cuda_ms(lambda: mod.launch(*args, **kw), 3)
        row["plain_ms"] = cuda_ms(lambda: mod.plain(*args, **kw), 1,
                                  warmup=0)
        say(phase, **row)
    out = dict(ms=cuda_ms(lambda: [mod.launch(*a, **kw) for _, a in calls],
                          2),
               library_ms=None, calls=len(calls), shapes=len(first),
               checks=summary["checks"], max_abs_err=summary["max_abs_err"],
               **bound(n_bytes, n_ops))
    if mod is im:
        lib = [int_mm_args(*a[:2]) for _, a in calls]
        out["library_ms"] = cuda_ms(
            lambda: [torch._int_mm(*a) for a in lib], 2)
        del lib
    del calls, first
    return out


def tally(ctx: dict, phase: str, kernel: str, d: dict,
          launches: int) -> None:
    """Add one model's kernel time, bytes, operations and launches to the
    phase's sums (``ctx[phase + "_kernels"]``), which the kernels JSON
    line reports under the phase's keys."""
    e = ctx.setdefault(f"{phase}_kernels", {}).setdefault(
        kernel, dict(launches=0, ms=0.0, bytes=0, ops=0, library_ms=None))
    e["launches"] += launches
    e["ms"] += d["ms"]
    e["bytes"] += d["bytes"]
    e["ops"] += d["ops"]
    if d["library_ms"] is not None:
        e["library_ms"] = (e["library_ms"] or 0.0) + d["library_ms"]


def first_leaf_per_shape(cfg, plans: dict, tag: str) -> list:
    """``(tag.name, leaf)`` of the first site instance of each distinct
    (R, C) of compiled exact plans, for ``check_k1_search``."""
    seen, out = set(), []
    for name, leaf, _ in step_calls(cfg, plans):
        shape = (leaf["w_q"].shape[0], leaf["planes"].shape[-1])
        if shape not in seen:
            seen.add(shape)
            out.append((f"{tag} search.{name}", leaf))
    return out


def phase_encoder(ctx: dict, rows: list) -> None:
    """The encoder-only models whole at their published sizes (random bf16
    weights from seed 0): raella-bert-large on token ids and hubert-xlarge
    on frame embeddings, ENCODER_BATCH sequences of ENCODER_SEQ positions
    each."""
    for arch in ENCODER_ARCHS:
        encoder_model(ctx, rows, arch)
    say("encoder", ok=True, archs=json.dumps(ENCODER_ARCHS),
        kernel_checks=len([r for r in rows if str(r.get("site", ""))
                           .startswith(ENCODER_ARCHS)]))


def encoder_model(ctx: dict, rows: list, arch: str) -> None:
    """One encoder through ``transformer.forward`` in every mode: off,
    exact (pinned (4,2,2): K2), int8, fast (K3), exact with speculation
    off (K1) and exact on Algorithm 1's plans (K1 in the compile, then
    K2), each forward's launches counted from the plans; exact, exact
    without speculation and adaptive logits equal int8's at the 24b ADC.
    The K1, K2 and K3 calls of one forward at ENCODER_ROWS rows, one per
    distinct shape, and K1 at Algorithm 1's search shape held bit for bit
    against the plain versions; each kernel's calls of one forward timed
    beside their bound. ``lm_loss`` on the card; for bert, an exact
    forward at the paper's 7b ADC with every layer's work stats."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import calibration_tokens
    from repro_torch.models import pim
    from repro_torch.models import transformer as T
    cfg0 = configs.get(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()  # the serve phase's plans, if run
    t0 = time.perf_counter()
    params = T.init_params(cfg0, seed=0, device="cuda")
    torch.cuda.synchronize()
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = encoder_inputs(cfg0, ENCODER_BATCH, ENCODER_SEQ, gen)
    if cfg0.input_mode == "tokens":
        calib = calibration_tokens(cfg0, 16)
    else:  # calibration_tokens' (2, 16), as frame embeddings
        calib = encoder_inputs(cfg0, 2, 16, gen)
    say("encoder", arch=arch, layers=cfg0.n_layers, d_model=cfg0.d_model,
        n_heads=cfg0.n_heads, d_ff=cfg0.d_ff, vocab=cfg0.vocab_size,
        causal=cfg0.causal, activation=cfg0.activation,
        input_mode=cfg0.input_mode, inputs=json.dumps(list(x.shape)),
        dtype=cfg0.dtype, params=n_params_of(params),
        init_s=round(time.perf_counter() - t0, 3), peak_gb=peak_gb(base),
        resident_before_gb=round(base / 2**30, 3))
    encoder_forward(params, cfg0, x, None)  # warm-up: cuBLAS, allocator
    positions = ENCODER_BATCH * ENCODER_SEQ
    runs = (("off", dict(pim_mode="off"), {}),
            ("exact", dict(pim_mode="exact"), PER_CALL["exact"]),
            ("int8", dict(pim_mode="int8"), PER_CALL["int8"]),
            ("fast", dict(pim_mode="fast"), PER_CALL["fast"]),
            ("exact-nospec", dict(pim_mode="exact", pim_speculation=False),
             PER_CALL["exact-nospec"]),
            ("exact-adaptive", dict(pim_mode="exact",
                                    pim_weight_slicing="adaptive"),
             PER_CALL["exact-adaptive"]))
    logits, plans, launches = {}, {}, {}
    for run, over, per_call in runs:
        cfg = dataclasses.replace(cfg0, **over)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        compile_launches = None
        if run == "exact-nospec":  # the pinned exact plans
            comp = plans["exact"]
        elif run != "off":
            ops.reset_launch_counts()
            comp = pim.compile_pim_params(params, cfg, calib)
            torch.cuda.synchronize()
            compile_launches = ops.launch_counts()
        compile_s = time.perf_counter() - t0
        p = None if run == "off" else comp.plans
        out, fwd_s, launches[run] = encoder_forward(params, cfg, x, p)
        n_proj = 0 if p is None else len(step_calls(cfg, p))
        want = {k: per_call.get(k, 0) * n_proj for k in launches[run]}
        if launches[run] != want:
            raise AssertionError(f"{arch} {run}: launches {launches[run]}, "
                                 f"want {want}")
        if not (out.shape == (ENCODER_BATCH, ENCODER_SEQ, cfg0.vocab_size)
                and bool(torch.isfinite(out).all())):
            raise AssertionError(f"{arch} {run}: logits {tuple(out.shape)} "
                                 "not finite or of the wrong shape")
        row = dict(mode=f"{arch} {run}", forward_s=round(fwd_s, 4),
                   positions_per_s=round(positions / fwd_s, 1),
                   launches=json.dumps(launches[run]),
                   projections=n_proj, peak_gb=peak_gb(base))
        if run not in ("off", "exact-nospec"):
            row.update(compile_s=round(compile_s, 3), sites=len(comp.sites),
                       compile_launches=json.dumps(compile_launches))
        if run == "exact-adaptive":
            if compile_launches["fused_crossbar"] <= 0:
                raise AssertionError("Algorithm 1's compile launched no K1")
            errs = [sp.error for sp in comp.sites]
            row.update(slice_histogram=json.dumps(comp.slice_histogram()),
                       mean_site_error=sum(errs) / len(errs),
                       max_site_error=max(errs))
        logits[run] = out
        if run not in ("off", "exact-nospec"):
            plans[run] = comp
        say("encoder", **row)
        del out
    for run in ("exact", "exact-nospec", "exact-adaptive"):
        if not torch.equal(logits[run], logits["int8"]):
            raise AssertionError(f"{arch} {run} logits differ from int8's "
                                 "at the 24b ADC")
    ref = logits["off"].float()
    for run in ("int8", "fast"):
        got = logits[run].float()
        say("encoder", mode=f"{arch} {run} against off",
            max_abs_diff=float((got - ref).abs().max()),
            rel_l2=float((got - ref).norm() / ref.norm()),
            argmax_agreement=float((got.argmax(-1) == ref.argmax(-1))
                                   .float().mean()))
    del logits, ref, got
    # one forward's kernel calls at ENCODER_ROWS rows
    tag = f"{arch} forward"
    exact = dataclasses.replace(cfg0, pim_mode="exact")
    kw = dict(phase="encoder", n_rows=ENCODER_ROWS)
    k2 = engine_call_kernel("fused_spec_crossbar", exact,
                            plans["exact"].plans, gen, rows, tag, **kw)
    k2a = engine_call_kernel("fused_spec_crossbar", exact,
                             plans["exact-adaptive"].plans, gen, rows,
                             f"{tag}, Algorithm 1's plans", **kw)
    k1 = engine_call_kernel("fused_crossbar", exact, plans["exact"].plans,
                            gen, rows, f"{tag}, speculation off", **kw)
    k3 = engine_call_kernel("centered_int8_matmul",
                            dataclasses.replace(cfg0, pim_mode="fast"),
                            plans["fast"].plans, gen, rows, tag, **kw)
    search = check_k1_search(
        "encoder", dataclasses.replace(exact, pim_weight_slicing="adaptive"),
        first_leaf_per_shape(exact, plans["exact-adaptive"].plans, arch),
        rows,
        gen, timed=True)
    for name, d, scope, n in (
            ("fused_spec_crossbar", k2, "one forward", launches["exact"]),
            ("fused_spec_crossbar", k2a, "one forward, Algorithm 1's plans",
             launches["exact-adaptive"]),
            ("fused_crossbar", k1, "one forward, speculation off",
             launches["exact-nospec"]),
            ("centered_int8_matmul", k3, "one forward", launches["fast"]),
            ("fused_crossbar", search, "Algorithm 1's search shape, one "
             "instance per distinct (R, C)", None)):
        say("encoder", kernel=name, scope=f"{arch}, {scope}, "
            f"{ENCODER_ROWS} rows" if n is not None else f"{arch}, {scope}",
            **d)
        if n is not None and d is not k2a:
            tally(ctx, "encoder", name, d, n[name])
    del plans["fast"], plans["int8"], plans["exact-adaptive"]
    # lm_loss on the card: float in every pim_mode, chunked over positions
    labels = torch.randint(0, cfg0.vocab_size,
                           (ENCODER_BATCH, ENCODER_SEQ), generator=gen,
                           device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        loss = float(T.lm_loss(params, cfg0, {"inputs": x, "labels": labels}))
    loss_s = time.perf_counter() - t0
    if not math.isfinite(loss):
        raise AssertionError(f"{arch} lm_loss {loss} is not finite")
    say("encoder", mode=f"{arch} lm_loss", loss=loss, loss_s=round(loss_s, 4),
        log_vocab=round(math.log(cfg0.vocab_size), 4),
        loss_chunk=T.LOSS_CHUNK)
    if arch == ENCODER_ARCHS[0]:
        encoder_adc7(params, exact, x, plans["exact"].plans)
    del params, plans, x
    torch.cuda.empty_cache()
    say("encoder", ok=True, arch=arch, exact_equals_int8=True,
        nospec_equals_int8=True, adaptive_equals_int8=True)


def encoder_adc7(params, exact, x, plans: dict) -> None:
    """One exact forward at the paper's 7b ADC on the pinned plans, every
    layer's work stats collected: converts per position, the
    speculation-failure share and how far the logits moved from the 24b
    ones. No contract. No entry point collects stats over a full-sequence
    forward (``transformer.forward`` suspends collection over its layers,
    as the reference does, and the serve engines, which collect, refuse
    encoders), so the layers run here one by one through ``apply_block``;
    the logits must equal ``forward``'s."""
    import dataclasses
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(exact, pim_adc_bits=7)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad(), L.collect_pim_stats() as sink:
        h = T.embed_inputs(params, cfg, x)
        B, S = h.shape[0], h.shape[1]
        pos = torch.arange(S, device=h.device).expand(B, S)
        for layer, (bp, plan) in enumerate(zip(params["layers"],
                                               plans["layers"])):
            h = T.apply_block(bp, cfg, layer, h, pos, plan)
        h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
        logits = L.lm_head(params["embed"], cfg, h, plan=plans["head"])
        tot = L.pim_stats_totals(sink)
    fwd_s = time.perf_counter() - t0
    with torch.no_grad():
        if not torch.equal(logits, T.forward(params, cfg, x, plans)):
            raise AssertionError("the 7b layer-by-layer forward differs "
                                 "from transformer.forward")
        at24 = T.forward(params, exact, x, plans).float()
    got, n = logits.float(), B * S
    say("encoder", mode=f"{cfg.name} exact at the 7b ADC", adc_bits=7,
        forward_s=round(fwd_s, 4),
        adc_converts_per_position=tot["adc_converts"] / n,
        no_spec_converts_per_position=tot["no_spec_converts"] / n,
        spec_failures=tot["spec_failures"],
        spec_attempts=tot["spec_attempts"],
        spec_failure_share=tot["spec_failures"] / tot["spec_attempts"],
        recovery_saturations=tot["recovery_saturations"],
        max_abs_diff_from_24b=float((got - at24).abs().max()),
        argmax_agreement_with_24b=float(
            (got.argmax(-1) == at24.argmax(-1)).float().mean()))


def check_k2_adc7(cfg, plans: dict, gen, rows: list, tag: str,
                  site: str) -> dict:
    """K2 at the paper's 7b ADC on the first call of ``site`` in one
    decode step, against the plain version bit for bit: psum, failures
    per spec slice and recovery saturations, which the clamps must make
    non-zero (a 7b window on 8b codes over 512 rows)."""
    from repro_torch.kernels import fused_spec_crossbar as fs
    calls = kernel_calls("fused_spec_crossbar", cfg, plans, gen)[0]
    name, args = next(c for c in calls if c[0] == f"{site}+")
    del calls
    kw = dict(adc_lo=-64, adc_hi=63)
    got = fs.launch(*args, **kw)
    row = compare("fused_spec_crossbar", got, fs.plain(*args, **kw),
                  site=f"{tag}.{name}", B=args[0].shape[0],
                  R=args[0].shape[1], C=got[0].shape[-1], adc_bits=7,
                  n_seg=args[1].shape[1] // 512,
                  failures=json.dumps(got[1].tolist()),
                  recovery_sats=int(got[2]))
    if not (int(got[1].sum()) > 0 and int(got[2]) > 0):
        raise AssertionError(f"{tag}.{name}: no failure or recovery "
                             "saturation at the 7b ADC")
    rows.append(row)
    return row


def report_summary(compiled) -> dict:
    """``CompiledPim.report()``'s whole-model numbers (4096 tokens)."""
    rep = compiled.report()
    return {f"report_{k}": (json.dumps(rep[k]) if isinstance(rep[k], dict)
                            else rep[k])
            for k in ("converts_per_mac", "adc_energy_share", "energy_uj",
                      "slice_histogram", "n_sites")}


def phase_decoders(ctx: dict, rows: list) -> None:
    """The last three dense decoders at their published widths, depth cut
    to fit the card (``DECODERS``)."""
    for arch, n_layers, adaptive in DECODERS:
        decoder_model(ctx, rows, arch, n_layers, adaptive)
    say("decoders", ok=True, archs=json.dumps([d[0] for d in DECODERS]),
        kernel_checks=len([r for r in rows if str(r.get("site", ""))
                           .startswith(tuple(d[0] for d in DECODERS))]))


def decoder_model(ctx: dict, rows: list, arch: str, n_layers: int,
                  adaptive: bool) -> None:
    """Serve one decoder (published widths, ``n_layers`` layers, random
    bf16 weights from seed 0) through ``ContinuousServeEngine`` in exact
    (pinned (4,2,2): K2), int8 and fast (K3) mode, and with ``adaptive``
    exact on Algorithm 1's per-site plans (K1 in the compile, then K2):
    launches per engine call from the plans, exact == int8 (== adaptive)
    tokens, each exact compile's energy report. While each plan set is
    alive, one decode step's K2 (pinned and Algorithm 1's plans) and K3
    calls are held bit for bit against the plain versions and timed, K2
    once more at the 7b ADC on the down projection (the widest R), and K1
    at Algorithm 1's search shape: on each distinct (R, C) of the adaptive
    plans with ``adaptive``, else on the down projection alone. Each plan
    set is freed before the next compile."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import calibration_tokens
    from repro_torch.models import layers as L
    from repro_torch.models import pim
    from repro_torch.models import transformer as T
    from repro_torch.serve import ContinuousServeEngine
    full = configs.get(arch)
    cfg0 = dataclasses.replace(full, n_layers=n_layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()  # the serve phase's plans, if run
    t0 = time.perf_counter()
    params = T.init_params(cfg0, seed=0, device="cuda")
    torch.cuda.synchronize()
    say("decoders", arch=arch, layers=cfg0.n_layers,
        reduced=f"n_layers {full.n_layers} -> {cfg0.n_layers}",
        d_model=cfg0.d_model, n_heads=cfg0.n_heads,
        n_kv_heads=cfg0.n_kv_heads, head_dim=cfg0.resolved_head_dim,
        d_ff=cfg0.d_ff, vocab=cfg0.vocab_size, qk_norm=cfg0.qk_norm,
        qkv_bias=cfg0.qkv_bias, dtype=cfg0.dtype,
        params=n_params_of(params), init_s=round(time.perf_counter() - t0, 3),
        peak_gb=peak_gb(base), resident_before_gb=round(base / 2**30, 3))
    reqs = serve_requests(cfg0.vocab_size)
    max_len = BLOCK * -(-(max(len(r.prompt) for r in reqs) + 8 + 1) // BLOCK)
    calib = calibration_tokens(cfg0, 16)
    gen = torch.Generator(device="cuda").manual_seed(3)
    tokens: dict = {}

    def compile_plans(cfg):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        compiled = pim.compile_pim_params(params, cfg, calib)
        torch.cuda.synchronize()
        return compiled, dict(compile_s=round(time.perf_counter() - t0, 3),
                              compile_launches=json.dumps(
                                  ops.launch_counts()),
                              sites=len(compiled.sites),
                              compile_peak_gb=peak_gb(base))

    def serve(run, cfg, plans):
        eng = ContinuousServeEngine(cfg, params, plans=plans,
                                    n_slots=N_SLOTS, max_len=max_len,
                                    prefill_chunk=64)
        with L.collect_pim_stats() as sink:
            outs, serve_s, launches = drive(eng, reqs)
            totals = L.pim_stats_totals(sink)
        row = engine_row(f"{arch} {run}", eng, outs, serve_s, launches,
                         PER_CALL[cfg.pim_mode], cfg.vocab_size)
        row.update(peak_gb=peak_gb(base),
                   projections_per_call=len(step_calls(cfg, plans)))
        if cfg.pim_mode == "exact":
            row.update(adc_converts_per_token=totals["adc_converts"]
                       / row["tokens"],
                       spec_failures=totals["spec_failures"])
        tokens[run] = [o.tokens.tolist() for o in outs]
        return row

    def record(kernel, d, scope, launches):
        say("decoders", kernel=kernel, scope=f"{arch}, {scope}", **d)
        tally(ctx, "decoders", kernel, d, launches)

    tag = f"{arch} decode step"
    down = f"{n_layers - 1}.w2"  # R = d_ff: the most segments of any site
    # exact, pinned (4,2,2): K2 per projection and the head
    exact = dataclasses.replace(cfg0, pim_mode="exact")
    compiled, info = compile_plans(exact)
    row = serve("exact", exact, compiled.plans)
    k2_launches = json.loads(row["launches"])["fused_spec_crossbar"]
    say("decoders", **row, **info, **report_summary(compiled))
    record("fused_spec_crossbar",
           engine_call_kernel("fused_spec_crossbar", exact, compiled.plans,
                              gen, rows, tag, "decoders"),
           "one decode step", k2_launches)
    say("decoders", **check_k2_adc7(exact, compiled.plans, gen, rows, tag,
                                    down))
    if not adaptive:  # K1 at the search shape on the widest R
        check_k1_search("decoders", exact, [
            (f"{arch} search.{down}", compiled.plans["layers"][-1]["ffn"]
             ["w2"])], rows, gen)
    del compiled
    # int8: the ideal 8b reference, no kernel
    int8 = dataclasses.replace(cfg0, pim_mode="int8")
    compiled, info = compile_plans(int8)
    say("decoders", **serve("int8", int8, compiled.plans), **info)
    del compiled
    if tokens["exact"] != tokens["int8"]:
        raise AssertionError(f"{arch} exact tokens differ from int8 tokens "
                             "at the 24b ADC")
    # fast: K3 per projection and the head
    fast = dataclasses.replace(cfg0, pim_mode="fast")
    compiled, info = compile_plans(fast)
    row = serve("fast", fast, compiled.plans)
    say("decoders", **row, **info)
    record("centered_int8_matmul",
           engine_call_kernel("centered_int8_matmul", fast, compiled.plans,
                              gen, rows, tag, "decoders"), "one decode step",
           json.loads(row["launches"])["centered_int8_matmul"])
    del compiled
    if adaptive:  # exact on Algorithm 1's plans: K1 per site, then K2
        adapt = dataclasses.replace(exact, pim_weight_slicing="adaptive")
        compiled, info = compile_plans(adapt)
        search = json.loads(info["compile_launches"])["fused_crossbar"]
        if search <= 0:
            raise AssertionError("Algorithm 1's compile launched no K1")
        errs = [sp.error for sp in compiled.sites]
        say("decoders", **serve("exact-adaptive", adapt, compiled.plans),
            **info, search_k1_launches=search,
            distinct_slicings=json.dumps(["-".join(map(str, sl)) for sl in
                                          compiled.distinct_slicings()]),
            mean_site_error=sum(errs) / len(errs), max_site_error=max(errs),
            **report_summary(compiled))
        say("decoders", kernel="fused_spec_crossbar",
            scope=f"{arch}, one decode step, Algorithm 1's plans",
            **engine_call_kernel("fused_spec_crossbar", adapt, compiled.plans,
                                 gen, rows, f"{tag}, Algorithm 1's plans",
                                 "decoders"))
        k1 = check_k1_search(
            "decoders", adapt, first_leaf_per_shape(adapt, compiled.plans,
                                                    arch), rows, gen,
            timed=True)
        record("fused_crossbar", k1, "Algorithm 1's search shape, one "
               "instance per distinct (R, C)", search)
        del compiled
        if tokens["exact-adaptive"] != tokens["exact"]:
            raise AssertionError(f"{arch} exact-adaptive tokens differ from "
                                 "exact tokens at the 24b ADC")
    del params
    torch.cuda.empty_cache()
    say("decoders", ok=True, arch=arch, exact_equals_int8=True,
        adaptive_equals_exact=adaptive or None,
        first_tokens=json.dumps(tokens["exact"][0]))


def prefix_requests(vocab: int):
    """4 requests whose prompts share a 32-token prefix (2 blocks), each
    with 4-8 tokens of its own, 8 new tokens each (seeded)."""
    import numpy as np
    from repro_torch.serve import Request
    rng = np.random.default_rng(2)
    prefix = rng.integers(0, vocab, 2 * BLOCK)
    return [Request(uid=u, prompt=np.concatenate(
        [prefix, rng.integers(0, vocab, n)]).astype(np.int32),
        max_new_tokens=8) for u, n in enumerate((4, 8, 6, 5))]


@contextlib.contextmanager
def step_timer(eng):
    """Time each ``eng.step()`` from outside the engine, with no recorder
    installed: ``eng.step_s["prefill"]`` holds the seconds of the steps
    that ran a prefill chunk (a chunk that no prompt finishes is not
    synced, so its device time may fall into the next step),
    ``eng.step_s["decode"]`` those of the steps that only decoded, and
    ``eng.decode_only_tokens`` the tokens those decoded."""
    step = eng.step
    eng.step_s = {"prefill": [], "decode": []}
    eng.decode_only_tokens = 0

    def timed():
        st = eng.stats
        c0, d0, k0 = st.prefill_chunks, st.decode_steps, st.decode_slot_tokens
        t = time.perf_counter()
        out = step()
        dt = time.perf_counter() - t
        if st.prefill_chunks > c0:
            eng.step_s["prefill"].append(dt)
        elif st.decode_steps > d0:
            eng.step_s["decode"].append(dt)
            eng.decode_only_tokens += st.decode_slot_tokens - k0
        return out
    eng.step = timed
    try:
        yield
    finally:
        del eng.step


def drive(eng, reqs, first=None):
    """Serve ``reqs`` with every launch count zeroed just before and read
    just after, each step timed (``step_timer``). With ``first``, that
    request runs alone until its prompt blocks are registered for
    sharing, then ``reqs`` join."""
    import torch
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    outs = []
    with step_timer(eng):
        if first is not None:
            eng.submit(first)
            while not eng.alloc.prefix_index:
                outs += eng.step()
        outs += eng.run(reqs)
        torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    assert len(outs) == len(reqs) + (first is not None)
    return (sorted(outs, key=lambda o: o.uid), serve_s,
            ops.launch_counts())


# each serve run's launches per engine call (decode step or prefill
# chunk): every projection through one kernel, both signed passes in exact
# mode; no other kernel launches
PER_CALL = {"exact": {"fused_spec_crossbar": 2}, "int8": {},
            "fast": {"centered_int8_matmul": 1},
            "exact-nospec": {"fused_crossbar": 2},
            "exact-adaptive": {"fused_spec_crossbar": 2},
            "paged-exact": {"fused_spec_crossbar": 2},
            "paged-prefix": {"centered_int8_matmul": 1},
            "continuous-prefix": {"centered_int8_matmul": 1},
            "paged-int8kv": {"centered_int8_matmul": 1},
            "continuous-int8kv": {"centered_int8_matmul": 1}}


def decode_step_ms(eng) -> float:
    """Mean milliseconds of the engine's steps that only decoded
    (``step_timer``)."""
    d = eng.step_s["decode"]
    return 1e3 * sum(d) / max(len(d), 1)


def engine_row(run: str, eng, outs, serve_s: float, launches: dict,
               per_call: dict, vocab: int, served: dict | None = None,
               n_new: int = 8) -> dict:
    """One serve line: each request's ``n_new`` tokens in the vocabulary,
    and the launches the serving made (``served``, default ``launches``) equal to
    ``per_call[kernel]`` x projections x engine calls for every kernel."""
    st = eng.stats
    served = launches if served is None else served
    calls = st.decode_steps + st.prefill_chunks
    # weight-static projections a call
    n_proj = len(step_calls(eng.cfg, eng.plans))
    assert all(o.finish_reason == "length" and len(o.tokens) == n_new
               and all(0 <= int(t) < vocab for t in o.tokens) for o in outs)
    want = {k: per_call.get(k, 0) * n_proj * calls for k in served}
    if served != want:
        raise AssertionError(f"{run}: launches {served}, want {want}")
    n_tok = sum(len(o.tokens) for o in outs)
    decode_s = sum(eng.step_s["decode"])
    row = dict(mode=run, engine=type(eng).__name__,
               serve_s=round(serve_s, 3),
               prefill_s=round(sum(eng.step_s["prefill"]), 3),
               decode_s=round(decode_s, 3), tokens=n_tok,
               decode_steps=st.decode_steps,
               prefill_chunks=st.prefill_chunks,
               step_ms=round(decode_step_ms(eng), 2),
               tok_per_s=round(n_tok / serve_s, 2),
               decode_tok_per_s=round(eng.decode_only_tokens
                                      / max(decode_s, 1e-9), 2),
               launches=json.dumps(launches),
               launches_per_step=json.dumps(
                   {k: v / calls for k, v in served.items()}))
    if hasattr(eng, "alloc"):
        row.update(n_blocks=eng.alloc.n_blocks, block_size=BLOCK,
                   blocks_in_use=st.blocks_in_use,
                   peak_blocks_in_use=st.peak_blocks_in_use,
                   evictions=st.evictions,
                   prefix_block_hits=st.prefix_block_hits,
                   admission_waits=st.admission_waits)
    return row


def serve_paged(ctx: dict, params, cfg0, reqs, tokens: dict,
                max_len: int) -> None:
    """The paged engine at full width: exact mode (K2) under a pool that
    must evict, fast mode (K3) with a shared 2-block prefix, and fast mode
    with an int8 KV cache, each held to the continuous engine's tokens;
    then the int8-KV runs of both engines again under ``torch.profiler``."""
    import dataclasses
    from repro_torch.serve import ContinuousServeEngine, PagedServeEngine
    vocab = cfg0.vocab_size
    exact = dataclasses.replace(cfg0, pim_mode="exact")
    fast = dataclasses.replace(cfg0, pim_mode="fast")
    # paged-exact: the requests need 8 blocks at their peak, the pool has 5
    eng = PagedServeEngine(exact, params, n_slots=N_SLOTS, max_len=max_len,
                           prefill_chunk=64, block_size=BLOCK, n_blocks=5,
                           plans=ctx["exact_compiled"].plans)
    outs, serve_s, launches = drive(eng, reqs)
    row = engine_row("paged-exact", eng, outs, serve_s, launches,
                     PER_CALL["paged-exact"], vocab)
    if not (eng.stats.evictions >= 1 and eng.stats.blocks_in_use == 0):
        raise AssertionError(f"paged-exact: {eng.stats}")
    if [o.tokens.tolist() for o in outs] != tokens["exact"]:
        raise AssertionError("paged-exact tokens differ from the continuous "
                             "engine's exact tokens")
    say("serve", **row, equals_continuous_exact=True)
    # paged-prefix: the first request registers the prefix, 3 share it
    preqs = prefix_requests(vocab)
    kw = dict(n_slots=N_SLOTS, max_len=3 * BLOCK, prefill_chunk=2 * BLOCK,
              plans=ctx["fast_plans"])
    eng = PagedServeEngine(fast, params, block_size=BLOCK, **kw)
    outs, serve_s, launches = drive(eng, preqs[1:], first=preqs[0])
    row = engine_row("paged-prefix", eng, outs, serve_s, launches,
                     PER_CALL["paged-prefix"], vocab)
    if eng.stats.prefix_block_hits != 6 or eng.stats.blocks_in_use != 0:
        raise AssertionError(f"paged-prefix: {eng.stats}")
    cont = ContinuousServeEngine(fast, params, **kw)
    couts, cserve_s, claunches = drive(cont, preqs)
    if [o.tokens.tolist() for o in outs] != [o.tokens.tolist()
                                            for o in couts]:
        raise AssertionError("paged-prefix tokens differ from the "
                             "continuous engine's")
    say("serve", **row, equals_continuous=True)
    say("serve", **engine_row("continuous-prefix", cont, couts, cserve_s,
                              claunches, PER_CALL["continuous-prefix"],
                              vocab))
    # paged-int8kv: int8 KV, prefix sharing off, against the continuous
    kv8 = dataclasses.replace(fast, kv_cache_dtype="int8")
    kw = dict(n_slots=N_SLOTS, max_len=max_len, prefill_chunk=64,
              plans=ctx["fast_plans"])

    def int8kv_engines():
        return (PagedServeEngine(kv8, params, block_size=BLOCK, **kw),
                ContinuousServeEngine(kv8, params, **kw))
    eng, cont = int8kv_engines()
    if eng.prefix_sharing is not False:
        raise AssertionError("prefix sharing is on under an int8 KV cache")
    outs, serve_s, launches = drive(eng, reqs)
    couts, cserve_s, claunches = drive(cont, reqs)
    got = [o.tokens.tolist() for o in outs]
    if got != [o.tokens.tolist() for o in couts]:
        raise AssertionError("paged-int8kv tokens differ from the "
                             "continuous engine's")
    say("serve", **engine_row("paged-int8kv", eng, outs, serve_s, launches,
                              PER_CALL["paged-int8kv"], vocab),
        equals_continuous=True, equals_bf16_kv_fast=got == tokens["fast"])
    say("serve", **engine_row("continuous-int8kv", cont, couts, cserve_s,
                              claunches, PER_CALL["continuous-int8kv"],
                              vocab))
    for name, e in zip(("paged-int8kv", "continuous-int8kv"),
                       int8kv_engines()):
        say("serve", scope=f"{name} again, under torch.profiler",
            **device_profile(e, reqs))


def phase_telemetry(ctx: dict) -> None:
    """``repro_torch.obs`` on the serve phase's qwen1.5-0.5b, its pinned
    exact plans and its 4 requests: the live metrics of a continuous and
    a paged exact run held to ``ServeStats`` and their tokens to the serve
    phase's (telemetry off); K2's counters at the paper's 7b ADC held to a
    ``with_pim_stats`` replay of the same decode steps; the launcher's
    three outputs; telemetry's host cost per decode step."""
    import dataclasses
    from repro_torch import obs
    from repro_torch.core import energy as en
    from repro_torch.serve import ContinuousServeEngine, PagedServeEngine
    t_phase = time.perf_counter()
    q = ctx["qwen"]
    params, reqs, max_len = q["params"], q["reqs"], q["max_len"]
    want_tokens = q["tokens"]["exact"]
    exact = dataclasses.replace(q["cfg"], pim_mode="exact")
    plans = ctx["exact_compiled"].plans
    vocab = exact.vocab_size
    checked = []

    # 1. continuous exact, metrics and tracing on
    tel = obs.ServeTelemetry(engine="continuous", tracing=True)
    eng = ContinuousServeEngine(exact, params, n_slots=N_SLOTS,
                                max_len=max_len, prefill_chunk=64,
                                plans=plans, telemetry=tel)
    outs, serve_s, launches = drive(eng, reqs)
    row = engine_row("telemetry-exact", eng, outs, serve_s, launches,
                     PER_CALL["exact"], vocab)
    if [o.tokens.tolist() for o in outs] != want_tokens:
        raise AssertionError("tokens with telemetry on differ from the "
                             "serve phase's exact tokens")
    live = check_lifecycle(tel, eng, outs)
    lanes = check_trace(tel, outs)
    say("telemetry", **row, equals_telemetry_off=True, **live,
        trace_request_lanes=lanes)
    checked += ["continuous exact tokens == telemetry off",
                "counters == ServeStats", "histogram counts",
                "trace lanes"]

    # 2. exact at the paper's 7b ADC: one request, then its decode steps
    # replayed under with_pim_stats; then all 4 requests
    at7 = dataclasses.replace(exact, pim_adc_bits=7)
    tel = obs.ServeTelemetry(engine="adc7")
    eng = ContinuousServeEngine(at7, params, n_slots=1, max_len=max_len,
                                prefill_chunk=64, plans=plans, telemetry=tel)
    outs, _, _ = drive(eng, reqs[:1])
    got = pim_counters(tel)
    want = replay_decode(at7, params, plans, reqs[0], outs[0].tokens,
                         max_len)
    if got["totals"] != want:
        raise AssertionError(f"7b counters {got['totals']} != the replay's "
                             f"{want}")
    if not want["spec_failures"] > 0:
        raise AssertionError(f"no speculation failed at the 7b ADC: {want}")
    n_tok = got["decode_tokens"]
    pj = en.pim_work_energy_pj(want, 7)["total_pj"] / n_tok
    if got["pj_per_token"] != pj:
        raise AssertionError(f"pJ/token {got['pj_per_token']} != {pj}")
    say("telemetry", mode="exact at the 7b ADC, 1 request",
        counters_equal_replay=True, decode_tokens=n_tok,
        **per_token(want, n_tok), tokens=json.dumps(outs[0].tokens.tolist()))
    tel = obs.ServeTelemetry(engine="adc7x4")
    eng = ContinuousServeEngine(at7, params, n_slots=N_SLOTS,
                                max_len=max_len, prefill_chunk=64,
                                plans=plans, telemetry=tel)
    outs, serve_s, launches = drive(eng, reqs)
    got = pim_counters(tel)
    say("telemetry", **engine_row("telemetry-exact-7b", eng, outs, serve_s,
                                  launches, PER_CALL["exact"], vocab),
        decode_tokens=got["decode_tokens"],
        **per_token(got["totals"], got["decode_tokens"]),
        tokens_equal_24b=[o.tokens.tolist() for o in outs] == want_tokens)
    checked += ["7b counters == with_pim_stats replay", "spec_failures > 0",
                "pJ/token == energy model"]

    # 3. paged exact on 5 blocks, evicting
    tel = obs.ServeTelemetry(engine="paged")
    eng = PagedServeEngine(exact, params, n_slots=N_SLOTS, max_len=max_len,
                           prefill_chunk=64, block_size=BLOCK, n_blocks=5,
                           plans=plans, telemetry=tel)
    outs, serve_s, launches = drive(eng, reqs)
    row = engine_row("telemetry-paged-exact", eng, outs, serve_s, launches,
                     PER_CALL["paged-exact"], vocab)
    if [o.tokens.tolist() for o in outs] != want_tokens:
        raise AssertionError("paged tokens with telemetry differ from the "
                             "continuous exact tokens")
    st, r, lab = eng.stats, tel.registry, {"engine": "paged"}
    if st.evictions < 1:
        raise AssertionError(f"paged exact did not evict: {st}")
    pool = {name: getattr(r, kind)(name, "", ("engine",)).get(**lab)
            for kind, name in (
                ("counter", "repro_serve_evictions_total"),
                ("counter", "repro_serve_admission_waits_total"),
                ("gauge", "repro_serve_peak_blocks_in_use"),
                ("gauge", "repro_serve_blocks_in_use"))}
    if list(pool.values()) != [st.evictions, st.admission_waits,
                               st.peak_blocks_in_use, st.blocks_in_use]:
        raise AssertionError(f"pool series {pool} != {st}")
    say("telemetry", **row, pool_series_equal_stats=True,
        **check_lifecycle(tel, eng, outs))
    checked += ["paged exact evicts", "pool series == ServeStats",
                "paged tokens == continuous"]

    # 4. the launcher's three outputs
    say("telemetry", **launcher_outputs())
    checked += ["launcher metrics and trace load",
                "profiler trace names K2's kernel"]

    # 5. host cost: decode step with telemetry off and on, in turns
    for mode, over, per_call in (("exact", {}, PER_CALL["exact"]),
                                 ("fast", {"pim_mode": "fast"},
                                  PER_CALL["fast"])):
        cfg = dataclasses.replace(exact, **over)
        pl = plans if mode == "exact" else ctx["fast_plans"]
        steps = {"off": [], "on": []}
        for which in ("off", "on", "on", "off"):
            tel = (obs.ServeTelemetry(engine=mode, tracing=True)
                   if which == "on" else None)
            eng = ContinuousServeEngine(cfg, params, n_slots=N_SLOTS,
                                        max_len=max_len, prefill_chunk=64,
                                        plans=pl, telemetry=tel)
            outs, serve_s, launches = drive(eng, reqs)
            engine_row(f"telemetry-cost-{mode}", eng, outs, serve_s,
                       launches, per_call, vocab)
            steps[which].append(decode_step_ms(eng))
        off, on = (sum(v) / len(v) for v in (steps["off"], steps["on"]))
        say("telemetry", host_cost=mode, order="off,on,on,off",
            step_ms_off=json.dumps([round(v, 3) for v in steps["off"]]),
            step_ms_on=json.dumps([round(v, 3) for v in steps["on"]]),
            mean_off_ms=round(off, 3), mean_on_ms=round(on, 3),
            delta_ms=round(on - off, 3),
            delta_pct=round(100 * (on - off) / off, 2),
            **telemetry_step_host_us(cfg, params, pl))
    checked.append("host cost printed for exact and fast")
    say("telemetry", ok=True, phase_s=round(time.perf_counter() - t_phase, 1),
        checked=json.dumps(checked))


def telemetry_step_host_us(cfg, params, plans, reps: int = 200) -> dict:
    """Host time of one decode step's telemetry work alone, on the stats
    of one real decode step of N_SLOTS slots: the decode-step span, the
    device totals (exact mode) and their fetch, the PIM fold, the step
    counters and N_SLOTS token hooks. The engine does this work once a
    decode step; the step itself runs once, outside the timing."""
    import torch
    from repro_torch import obs
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    dev = params["embed"]["embed"].device
    with torch.no_grad(), L.collect_pim_stats() as sink:
        state = T.init_decode_state(cfg, N_SLOTS, 32, per_slot_pos=True,
                                    device=dev)
        T.decode_step(params, cfg, state, torch.ones(
            (N_SLOTS, 1), dtype=torch.int64, device=dev), plans=plans)
    tel = obs.ServeTelemetry(engine="cost", tracing=True)
    tel.pim_adc_bits = cfg.pim_adc_bits
    collect = tel.wants_pim_stats(cfg)
    for uid in range(N_SLOTS):
        tel.on_submit(uid)
        tel.on_admit(uid, 8)
        tel.on_token(uid)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        with tel.span("decode_step", n_live=N_SLOTS):
            if collect:
                tot = L.pim_stats_device_totals(sink)
                tel.on_pim_totals(tot.host(tot.counts.cpu()), N_SLOTS)
            tel.observe_decode_step_seconds(0.1)
            tel.on_decode_step(N_SLOTS)
            for uid in range(N_SLOTS):
                tel.on_token(uid)
    us = 1e6 * (time.perf_counter() - t0) / reps
    return dict(telemetry_host_us_per_step=round(us, 1),
                stats_objects_per_step=len(sink))


def check_lifecycle(tel, eng, outs) -> dict:
    """The live counters equal ``ServeStats`` and the outputs: decode
    steps, prefill chunks, completions, one e2e a request, and every
    committed token a TTFT or a TPOT. Without evictions, one TTFT a
    request and the outputs' tokens; an evicted request replays from
    scratch, and its replay commits (and may observe a TTFT) again."""
    from repro_torch.obs.serve import STEP_BUCKETS
    st, r, lab = eng.stats, tel.registry, {"engine": tel.engine}

    def count(name: str) -> float:
        return r.counter(name, "", ("engine",)).get(**lab)

    def hist(name: str, **kw) -> int:
        return r.histogram(name, "", ("engine",), **kw).get(**lab)["count"]
    n_tok = sum(len(o.tokens) for o in outs)
    done = r.counter("repro_serve_requests_completed_total", "",
                     ("engine", "reason"))
    got = dict(decode_steps=count("repro_serve_decode_steps_total"),
               prefill_chunks=count("repro_serve_prefill_chunks_total"),
               completed=sum(v for _, v in done.series()),
               e2e=hist("repro_serve_e2e_seconds"),
               tokens=count("repro_serve_tokens_generated_total"),
               ttft=hist("repro_serve_ttft_seconds"),
               tpot=hist("repro_serve_tpot_seconds", buckets=STEP_BUCKETS))
    want = dict(decode_steps=st.decode_steps,
                prefill_chunks=st.prefill_chunks, completed=len(outs),
                e2e=len(outs), tokens=got["ttft"] + got["tpot"])
    if st.evictions == 0:
        want.update(tokens=n_tok, ttft=len(outs), tpot=n_tok - len(outs))
    ok = all(got[k] == v for k, v in want.items()) and (
        len(outs) <= got["ttft"] <= len(outs) + st.evictions
        and got["tokens"] >= n_tok and st.completed == len(outs))
    if not ok:
        raise AssertionError(f"live metrics {got}, want {want} "
                             f"({st.evictions} evictions)")
    return dict(live_counters_equal_stats=True,
                live=json.dumps(got, sort_keys=True))


def check_trace(tel, outs) -> int:
    """The Chrome trace survives a JSON round trip, with one lane per
    request (tid = uid + 1)."""
    doc = json.loads(json.dumps(tel.tracer.chrome_trace()))
    req = [e for e in doc["traceEvents"] if e["name"] == "request"]
    lanes = sorted(e["tid"] for e in req)
    if lanes != sorted(o.uid + 1 for o in outs):
        raise AssertionError(f"trace request lanes {lanes}")
    return len(lanes)


def pim_counters(tel) -> dict:
    """The telemetry's ``repro_pim_*_total`` counters, decode tokens and
    pJ/token."""
    from repro_torch.models import layers as L
    r, lab = tel.registry, {"engine": tel.engine}
    return dict(
        totals={k: int(r.counter(f"repro_pim_{k}_total", "",
                                 ("engine",)).get(**lab))
                for k in L.PIM_STAT_KEYS},
        decode_tokens=int(r.counter("repro_pim_decode_tokens_total", "",
                                    ("engine",)).get(**lab)),
        pj_per_token=r.gauge("repro_pim_pj_per_token", "",
                             ("engine",)).get(**lab))


def per_token(tot: dict, n_tok: int) -> dict:
    """Converts, failures and energy per decode token (the paper's §2.5
    component model at the 7b ADC); converts per weight is per token over
    the weights both signed passes read."""
    from repro_torch.core import energy as en
    e = en.pim_work_energy_pj(tot, 7)
    return dict(adc_converts_per_token=tot["adc_converts"] / n_tok,
                no_spec_converts_per_token=tot["no_spec_converts"] / n_tok,
                converts_per_weight=2 * tot["adc_converts"] / tot["macs"],
                spec_failure_rate=tot["spec_failures"]
                / tot["spec_attempts"],
                saturations_per_token=tot["recovery_saturations"] / n_tok,
                pj_per_token=e["total_pj"] / n_tok,
                adc_pj_share=e["e_adc_pj"] / e["total_pj"])


def replay_decode(cfg, params, plans, req, tokens, max_len: int) -> dict:
    """The engine's decode steps of one request again, by hand, each under
    ``layers.with_pim_stats``: the prompt prefilled in one chunk into a
    B=1 state and inserted into slot 0 of a 1-slot state, as the engine
    does, then the request's own tokens fed back. Returns the summed
    totals; the greedy tokens must equal the engine's."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    step = L.with_pim_stats(lambda st, tok: T.decode_step(
        params, cfg, st, tok, plans=plans))
    want = dict.fromkeys(L.PIM_STAT_KEYS, 0)
    dev = params["embed"]["embed"].device
    with torch.no_grad():
        one = T.init_decode_state(cfg, 1, max_len, device=dev)
        logits, one = T.prefill_chunk(
            params, cfg, one, torch.as_tensor(req.prompt[None],
                                              dtype=torch.int64,
                                              device=dev), plans=plans)
        state = T.init_decode_state(cfg, 1, max_len, per_slot_pos=True,
                                    device=dev)
        T.insert_request(state, one, 0)
        replay = [int(torch.argmax(logits[0, -1].cpu()))]
        for tok in tokens[:-1]:
            logits, state, tot = step(state, torch.tensor(
                [[int(tok)]], dtype=torch.int64, device=dev))
            replay.append(int(torch.argmax(logits[0, -1].cpu())))
            for k, v in tot.host().items():
                want[k] += v
    if replay != [int(t) for t in tokens]:
        raise AssertionError(f"replay tokens {replay} != {tokens.tolist()}")
    return want


def launcher_outputs() -> dict:
    """``repro_torch.launch.serve.main`` on the card, paged exact with
    ``--metrics-out``, ``--trace-out`` and ``--profile-dir`` into a
    temporary directory: the metrics load with the PIM counters and the
    final ``ServeStats`` gauges, the span trace loads, and the profiler's
    trace names K2's CUDA kernel (``spec_kernel``) among its device
    events."""
    import tempfile
    from repro_torch.launch import serve as launch
    with tempfile.TemporaryDirectory() as d:
        m, t, prof = (str(Path(d) / n) for n in ("m.json", "t.json", "prof"))
        t0 = time.perf_counter()
        launch.main(["--arch", ARCH, "--pim", "exact", "--engine", "paged",
                     "--requests", "2", "--steps", "4", "--metrics-out", m,
                     "--trace-out", t, "--profile-dir", prof])
        launch_s = time.perf_counter() - t0
        doc = json.loads(Path(m).read_text())
        snap = doc["metrics"]
        stats = sorted(k for k in snap if k.startswith("repro_serve_stats_"))
        converts = snap["repro_pim_adc_converts_total"]["series"][0]["value"]
        if not (converts > 0 and len(stats) == len(doc["stats"])):
            raise AssertionError(f"metrics: converts {converts}, {stats}")
        spans = len(json.loads(Path(t).read_text())["traceEvents"])
        (path,) = Path(prof).iterdir()
        size = path.stat().st_size
        events = json.loads(path.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k2 = [e for e in kernels if "spec_kernel" in e.get("name", "")]
    if not k2:
        raise AssertionError("the profiler trace names no K2 kernel: "
                             f"{sorted({e.get('name') for e in kernels})[:8]}")
    return dict(launcher="paged exact, --metrics-out --trace-out "
                "--profile-dir", launch_s=round(launch_s, 3),
                metrics_series=len(snap), stats_gauges=len(stats),
                adc_converts_total=int(converts), trace_events=spans,
                profile_mb=round(size / 2**20, 1),
                profile_kernel_events=len(kernels), k2_kernel_events=len(k2),
                k2_name=short_name(k2[0]["name"]))


def kernel_times(prof) -> list:
    """Every device record of a finished ``torch.profiler`` window (each
    kernel, copy and fill: CUPTI's records) summed by name, read from the
    raw records: ``[name, launches, device µs]``, the most time first.
    ``key_averages()`` gives the same sums but first builds an event tree,
    which took several times the profiled run itself."""
    by_name: dict = {}
    for e in prof.profiler.kineto_results.events():
        if not str(e.device_type()).endswith("CUDA"):
            continue
        us = e.duration_ns() / 1e3
        if us > 0:
            t = by_name.setdefault(e.name(), [0, 0.0])
            t[0] += 1
            t[1] += us
    if not by_name:
        raise AssertionError("the profiler saw no kernel")
    return sorted(([k, n, us] for k, (n, us) in by_name.items()),
                  key=lambda r: r[2], reverse=True)


def top_kernels(kernels: list, n: int) -> str:
    """The ``n`` kernels of ``kernel_times`` that took the most, as JSON:
    short name, launches, device ms."""
    return json.dumps([[short_name(k), c, round(us / 1e3, 3)]
                       for k, c, us in kernels[:n]])


def device_profile(eng, reqs) -> dict:
    """Serve ``reqs`` under ``torch.profiler``: every kernel's device time
    summed by name (CUPTI records), the launches, and the six kernels that
    took the most. Only device activity is recorded: host-op records cost
    more to process than the run itself."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.run(reqs)
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    kernels = kernel_times(prof)
    st = eng.stats
    return dict(profiled_serve_s=round(wall_s, 3),
                decode_steps=st.decode_steps,
                prefill_chunks=st.prefill_chunks,
                all_kernels_device_ms=sum(r[2] for r in kernels) / 1e3,
                kernel_launches=sum(r[1] for r in kernels),
                top_kernels=top_kernels(kernels, 6))


def short_name(kernel: str) -> str:
    """A CUDA kernel's name without its namespaces, cut to 90 characters."""
    return re.sub(r"void |at::native::|\(anonymous namespace\)::|"
                  r"at::detail::", "", kernel)[:90]


def k1_compile_device_time(params, cfg, calib) -> dict:
    """Algorithm 1's full-width compile run again under ``torch.profiler``:
    K1's device time summed over its launches (CUPTI kernel records),
    beside every kernel's and the profiled wall time. The serve phase's
    ``compile_s`` is the unprofiled compile."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import fused_crossbar as fx
    from repro_torch.models import pim
    n0 = fx.KERNEL.launches
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        compiled = pim.compile_pim_params(params, cfg, calib)
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = fx.KERNEL.launches - n0
    kernels = kernel_times(prof)
    k1 = [r for r in kernels if "crossbar_kernel" in r[0]
          and "sliced" not in r[0]]
    k1_ms = sum(r[2] for r in k1) / 1e3
    k1_calls = sum(r[1] for r in k1)
    if k1_calls != launches or k1_ms <= 0:
        raise AssertionError(f"profiler saw {k1_calls} K1 kernels with "
                             f"{k1_ms} ms; the compile launched {launches}")
    return dict(profiled_compile_s=round(wall_s, 3), k1_launches=launches,
                k1_device_ms=k1_ms,
                all_kernels_device_ms=sum(r[2] for r in kernels) / 1e3,
                slice_histogram=json.dumps(compiled.slice_histogram()))


def check_sampling(cfg, params, plans, prompt) -> dict:
    """A sampled request (temperature 1.0, 8 new tokens) through the
    continuous engine draws the lockstep engine's B = 1 stream for its
    seed on the card; the same seed replays it, another seed does not."""
    import numpy as np
    from repro_torch.serve import ContinuousServeEngine, Request, ServeEngine
    n_new, seed = 8, 5
    max_len = len(prompt) + n_new + 1
    lock = ServeEngine(cfg, params, max_len=max_len, temperature=1.0,
                       plans=plans)
    want = lock.generate(prompt[None], steps=n_new, seed=seed).tokens[0]
    again = lock.generate(prompt[None], steps=n_new, seed=seed).tokens[0]
    other = lock.generate(prompt[None], steps=n_new, seed=seed + 1).tokens[0]
    eng = ContinuousServeEngine(cfg, params, n_slots=N_SLOTS, max_len=max_len,
                                prefill_chunk=64, plans=plans)
    [out] = eng.run([Request(uid=0, prompt=prompt, max_new_tokens=n_new,
                             temperature=1.0, seed=seed)])
    if not (np.array_equal(want, again) and np.array_equal(out.tokens, want)):
        raise AssertionError(
            f"sampled streams differ for seed {seed}: lockstep {want.tolist()}"
            f", replay {again.tolist()}, continuous {out.tokens.tolist()}")
    if np.array_equal(want, other):
        raise AssertionError(f"seeds {seed} and {seed + 1} drew one stream")
    return dict(sampled_mode=cfg.pim_mode, temperature=1.0, seed=seed,
                sampled_continuous_equals_lockstep=True,
                sampled_tokens=json.dumps(want.tolist()))


def step_calls(cfg, plans: dict) -> list:
    """One engine call's weight-static projections, in the model's order:
    (name, leaf, rows) per layer and projection (attention's q/k/v/o or
    mamba's in/x/out, then the FFN's; none on an rwkv layer) — one per
    expert in a MoE FFN, every expert, as the model runs them — then the
    LM head if the plans have one, with the rows each gets in a decode step
    of N_SLOTS slots (an expert its dispatch buffer's,
    ``layers.moe_dispatch_rows``)."""
    from repro_torch.models import layers as L
    out = []
    for layer, lp in enumerate(plans["layers"]):
        for g, leaves in (lp or {}).items():
            expert = g == "ffn" and L.is_moe_layer(cfg, layer)
            for n, leaf in leaves.items():
                name = f"{layer}.{n}"
                if expert:
                    rows = L.moe_dispatch_rows(cfg, N_SLOTS, 1)
                    out += [(f"{name}[e{e}]",
                             {k: v[e] for k, v in leaf.items()}, rows)
                            for e in range(cfg.n_experts)]
                else:
                    out.append((name, leaf, N_SLOTS))
    if "head" in plans:
        out.append(("head", plans["head"], N_SLOTS))
    return out


def check_step(rows: list, kernel: str, launch, plain, calls: list,
               tag: str, **kw) -> dict:
    """Every call of one decode step (``(name, args)`` pairs) through the
    kernel and its plain version on the same operands, bit for bit (K2
    and K1: psum and both counters), one row each in ``rows``; returns
    their summary. Raises on the first mismatch."""
    mine = []
    for name, args in calls:
        got = launch(*args, **kw)
        row = compare(kernel, got, plain(*args, **kw), site=f"{tag}.{name}",
                      B=args[0].shape[0], R=args[0].shape[1],
                      C=(got[0] if isinstance(got, tuple) else got).shape[-1])
        mine.append(row)
    rows += mine
    shapes = sorted({(r["B"], r["R"], r["C"]) for r in mine})
    return dict(kernel=kernel, scope=tag, match=True, checks=len(mine),
                tolerance=0, max_abs_err=max(r["max_abs_err"] for r in mine),
                shapes=json.dumps(shapes))


def bound(n_bytes: int, n_ops: int) -> dict:
    """The least time the card could take: bytes over HBM bandwidth or
    int8 operations over the tensor-core peak, whichever is larger."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / INT8_OPS_PER_S
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=n_bytes, ops=n_ops)


def check_k1_search(phase: str, cfg, leaves: list, rows: list, gen,
                    timed: bool = False) -> dict | None:
    """K1 as Algorithm 1 runs it, on each ``(tag, leaf)`` of compiled exact
    plans (one instance each): SEARCH_ROWS rows of codes 0..127 in 1b
    input slices on the leaf's planes (padded ones masked), at the 24b ADC
    and at the search ADC, bit for bit against the plain version, psum and
    saturations. With ``timed``, the 24b calls are timed beside their
    bound, which is returned."""
    import torch
    from repro_torch.core import adc as adc_lib
    from repro_torch.kernels import fused_crossbar as fx
    from repro_torch.kernels import ops
    from repro_torch.models import pim_compile as pc
    search = adc_lib.ADCConfig(bits=cfg.pim_search_adc_bits, signed=True)
    kw24 = dict(adc_lo=-(1 << 23), adc_hi=(1 << 23) - 1)
    calls, n_bytes, n_ops = [], 0, 0
    for tag, leaf in leaves:
        R = leaf["w_q"].shape[0]
        n_j, n_seg, rx, C = leaf["planes"].shape
        x = torch.randint(0, 128, (pc.SEARCH_ROWS, R), generator=gen,
                          device="cuda", dtype=torch.int32)
        args = (x, *ops.crossbar_tables(
            leaf["planes"], leaf["slice_shifts"], ONE_BIT,
            leaf["slice_valid"]), leaf["enc_centers"].contiguous())
        for kw in (kw24, dict(adc_lo=search.lo, adc_hi=search.hi)):
            got = fx.launch(*args, **kw)
            row = compare("fused_crossbar", got, fx.plain(*args, **kw),
                          site=tag, B=pc.SEARCH_ROWS, R=R, C=C,
                          n_j=int(leaf["slice_valid"].sum()),
                          adc_bits=24 if kw is kw24 else search.bits,
                          input_slicing="1x8", sats=int(got[1]))
            rows.append(row)
            say(phase, **row)
        calls.append(args)
        n_bytes += (4 * pc.SEARCH_ROWS * R + n_j * n_seg * rx * C
                    + 4 * 8 * n_j + 4 * n_seg * C + 4 * pc.SEARCH_ROWS * C
                    + 8)
        n_ops += 2 * pc.SEARCH_ROWS * R * C * n_j * 8
    if not timed:
        return None
    return dict(ms=cuda_ms(lambda: [fx.launch(*a, **kw24) for a in calls], 5),
                plain_ms=cuda_ms(lambda: [fx.plain(*a, **kw24)
                                          for a in calls], 1, warmup=0),
                library_ms=None, calls=len(calls), **bound(n_bytes, n_ops))


def expert_search_leaves(plans: dict) -> list:
    """``(tag, leaf)`` of the first expert instance of each slice count of
    layer 0's gate and down projections (R = 6400 leaves a ragged last
    segment), for ``check_k1_search``."""
    out = []
    for n in ("w1", "w2"):
        leaf = plans["layers"][0]["ffn"][n]
        n_valid = leaf["slice_valid"].sum(dim=-1).tolist()
        for n_j in sorted(set(n_valid)):
            e = n_valid.index(n_j)
            out.append((f"{MOE_ARCH} search.0.{n}[e{e}]",
                        {k: v[e] for k, v in leaf.items()}))
    return out


def k1_batch_tiles(gen) -> dict:
    """K1 at Algorithm 1's B = 16 (1b input slices, 3 planes, the four site
    shapes, 24b ADC) with batch tiles of 1, 2 and 4 rows forced: device
    time per call in µs, each plan held bit for bit against the plain
    version first."""
    import functools
    from repro_torch.kernels import bitplane, ops
    from repro_torch.kernels import fused_crossbar as fx
    kw = dict(adc_lo=-(1 << 23), adc_hi=(1 << 23) - 1)
    out = {}
    default = fx.tile_plan
    try:
        for site, (R, C) in SITE_SHAPES.items():
            xu, planes, shifts, centers = k2_inputs(16, R, C, gen)
            args = (xu, *ops.crossbar_tables(planes, shifts, ONE_BIT),
                    centers)
            want = fx.plain(*args, **kw)
            for bt in bitplane.BATCH_TILES:
                fx.tile_plan = functools.partial(bitplane.tile_plan, bt=bt)
                compare("fused_crossbar", fx.launch(*args, **kw), want,
                        site=site, B=16, bt=bt)
                out[f"{site}_bt{bt}_us"] = 1e3 * cuda_ms(
                    lambda: fx.launch(*args, **kw), 3)
            del xu, planes, centers, args, want
    finally:
        fx.tile_plan = default
    return out


def host_ms(fn, reps: int) -> float:
    """Mean host time to enqueue one call of ``fn`` (the device keeps up:
    these calls are short), synchronised before and after."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * dt / reps


def kv_copies(gen) -> dict:
    """The plain-PyTorch copies the paged engine adds to a decode step, at
    the serve phase's shapes (4 slots, max_len 32, blocks of 16, every
    layer): the block-table gathers of K and V (bf16 cache) or of K, V and
    their scales (int8 cache), and the int8 dequantize of K and V that
    both engines run. Device time (CUDA events) and host time per step."""
    import torch
    from repro_torch import configs
    from repro_torch.models import transformer as T
    cfg = configs.get(ARCH)
    layout = T.PagedLayout(n_blocks=8, block_size=BLOCK)
    shape = (layout.pool_rows, BLOCK, cfg.n_kv_heads, cfg.resolved_head_dim)
    tables = torch.arange(8, device="cuda").reshape(4, 2)
    n = 2 * cfg.n_layers  # K and V of every layer
    bf16 = [torch.randn(shape, generator=gen, device="cuda",
                        dtype=torch.bfloat16) for _ in range(n)]
    codes = [torch.randint(-127, 128, shape, generator=gen, device="cuda",
                           dtype=torch.int8) for _ in range(n)]
    scales = [torch.rand(shape[:-1], generator=gen, device="cuda")
              for _ in range(n)]

    def gather(pools):
        return [T._paged_gather(p, tables, layout) for p in pools]
    gq, gs = gather(codes), gather(scales)

    def dequant():
        return [T._dequantize_kv(q, sc, torch.bfloat16)
                for q, sc in zip(gq, gs)]
    calls = {"gather_bf16": lambda: gather(bf16),
             "gather_int8": lambda: gather(codes + scales),
             "dequant_int8": dequant}
    out = {"gathered_bytes_bf16": sum(2 * g.numel() for g in gather(bf16)),
           "layers": cfg.n_layers}
    for name, fn in calls.items():
        out[f"{name}_device_ms"] = cuda_ms(fn, 5)
        out[f"{name}_host_ms"] = host_ms(fn, 5)
    return out


def k3_step(cfg, plans: dict, gen, rows: list, tag: str,
            phase: str) -> tuple[list, dict]:
    """One decode step's K3 calls (int8 codes, N_SLOTS rows a projection,
    an expert its dispatch rows) on fast plans: each held bit for bit
    against the plain version (rows in ``rows``), then timed against it
    and ``torch._int_mm`` on x padded with zero rows (no center term),
    with the bytes and operations they need."""
    import torch
    from repro_torch.kernels import int8_matmul as im
    calls, n_bytes, n_ops, _ = kernel_calls("centered_int8_matmul", cfg,
                                            plans, gen)
    say(phase, **check_step(rows, "centered_int8_matmul", im.launch,
                            im.plain, calls, tag))
    lib_calls = [int_mm_args(x, w) for _, (x, w, _) in calls]
    return calls, dict(
        ms=cuda_ms(lambda: [im.launch(*a) for _, a in calls], 5),
        plain_ms=cuda_ms(lambda: [im.plain(*a) for _, a in calls], 2),
        library_ms=cuda_ms(lambda: [torch._int_mm(*a) for a in lib_calls], 5),
        library_rows=lib_calls[0][0].shape[0], calls=len(calls),
        **bound(n_bytes, n_ops))


K4_SETS = 3  # distinct weight sets K4's timing cycles through


def k4_timing(gen, B: int) -> dict:
    """K4 at the four projection shapes (8 one-bit slices, 3 planes, 24b
    ADC) at B rows, one call each, on ``K4_SETS`` distinct sets of weights
    in turn (489 MB a set), so L2 holds none of a call's planes from the
    repeat before; beside the plain version and the bound."""
    import itertools
    from repro_torch.kernels import sliced_crossbar as sx
    kw = dict(adc_lo=-(1 << 23), adc_hi=(1 << 23) - 1)
    sets = [[k4_inputs(B, R, C, gen) for R, C in SITE_SHAPES.values()]
            for _ in range(K4_SETS)]
    turn = itertools.cycle(sets)

    def step(fn):
        return [fn(*args, **kw) for args in next(turn)]
    # x slices, planes and mults read once, psum written once; 8 x 3
    # products of a multiply and an add per (b, r, c)
    shapes = SITE_SHAPES.values()
    n_bytes = sum(8 * B * R + 3 * R * C + 4 * 24 + 4 * B * C
                  for R, C in shapes)
    n_ops = sum(2 * 8 * 3 * B * R * C for R, C in shapes)
    out = dict(ms=cuda_ms(lambda: step(sx.launch), 5),
               plain_ms=cuda_ms(lambda: step(sx.plain), 1, warmup=0),
               library_ms=None, calls=len(SITE_SHAPES),
               **bound(n_bytes, n_ops))
    del sets, turn
    return out


def phase_timing(ctx: dict, rows: list) -> list:
    """Time one decode step's worth of each kernel's calls (B = 4 slots)
    on the compiled plans: distinct weights per layer, as the model has
    them, so the 50 MB L2 holds none of them between calls. K4, which no
    path calls, is timed at the four projection shapes at B = 4 and 64,
    its weights distinct per repeat."""
    import torch
    from repro_torch.kernels import fused_crossbar as fx
    from repro_torch.kernels import fused_spec_crossbar as fs
    from repro_torch import configs
    gen = torch.Generator(device="cuda").manual_seed(1)
    cfg = configs.get(ARCH)
    exact_plans = ctx["exact_compiled"].plans
    kw = dict(adc_lo=-(1 << 23), adc_hi=(1 << 23) - 1)  # the 24b ADC
    # K2: the spec-on exact plans
    k2_calls, k2_bytes, k2_ops = kernel_calls("fused_spec_crossbar", cfg,
                                              exact_plans, gen)[:3]

    def k2_step(fn):
        return [fn(*a, **kw) for _, a in k2_calls]
    fails = sum(int(r[1].sum()) for r in k2_step(fs.launch))
    assert fails == 0  # no recovery work at 24b: the bound is the spec dots
    k2 = dict(ms=cuda_ms(lambda: k2_step(fs.launch), 5),
              plain_ms=cuda_ms(lambda: k2_step(fs.plain), 1, warmup=0),
              library_ms=None, calls=len(k2_calls),
              **bound(k2_bytes, k2_ops))
    del k2_calls
    # K2 on Algorithm 1's plans: 3 planes per layer site, 8 on the head
    ka_calls, ka_bytes, ka_ops = kernel_calls(
        "fused_spec_crossbar", cfg, ctx["adaptive_plans"], gen)[:3]
    k2a = dict(ms=cuda_ms(lambda: [fs.launch(*a, **kw)
                                   for _, a in ka_calls], 5),
               plain_ms=cuda_ms(lambda: [fs.plain(*a, **kw)
                                         for _, a in ka_calls], 1,
                                warmup=0),
               library_ms=None, calls=len(ka_calls),
               **bound(ka_bytes, ka_ops))
    del ka_calls
    # K1: the same plans, speculation off (1b input slices)
    k1_calls, k1_bytes, k1_ops = kernel_calls(
        "fused_crossbar", cfg, exact_plans, gen, slicing=ONE_BIT)[:3]

    def k1_step(fn):
        return [fn(*a, **kw) for _, a in k1_calls]
    k1 = dict(ms=cuda_ms(lambda: k1_step(fx.launch), 5),
              plain_ms=cuda_ms(lambda: k1_step(fx.plain), 1, warmup=0),
              library_ms=None, calls=len(k1_calls),
              **bound(k1_bytes, k1_ops))
    # K3: one call per projection, int8 codes
    k3_calls, k3 = k3_step(cfg, ctx["fast_plans"], gen, rows,
                           f"{ARCH} decode step", "timing")
    # what as many back-to-back launches of an empty kernel take: the
    # share of the step that no kernel design removes
    z = torch.empty(1, device="cuda")
    k3["launch_floor_ms"] = cuda_ms(lambda: [z.zero_() for _ in k3_calls], 5)
    # K4: the four projection shapes, cold weights; beside it the kernels
    # phase's per-shape times (each shape repeated on one set of weights,
    # the way earlier runs timed it)
    k4 = k4_timing(gen, 4)
    k4["kernels_phase_ms"] = sum(
        r["kernel_ms"] for r in rows
        if r["kernel"] == "sliced_crossbar" and "kernel_ms" in r)
    k4_64 = k4_timing(gen, 64)
    table = (("fused_crossbar", k1, "one decode step, B=4, speculation off"),
             ("fused_spec_crossbar", k2, "one decode step, B=4"),
             ("fused_spec_crossbar", k2a,
              "one decode step, B=4, Algorithm 1's plans"),
             ("centered_int8_matmul", k3, "one decode step, B=4"),
             ("sliced_crossbar", k4, "the four projection shapes, B=4"),
             ("sliced_crossbar", k4_64, "the four projection shapes, B=64"))
    for name, d, scope in table:
        say("timing", kernel=name, scope=scope, **d)
    moe = {"fused_spec_crossbar": ctx.get("moe_k2"),
           "centered_int8_matmul": ctx.get("moe_k3")}
    for name, d in moe.items():
        if d is not None:
            say("timing", kernel=name, scope=f"one decode step of {MOE_ARCH}"
                f", {MOE_LAYERS} layers, B={N_SLOTS}, experts at "
                f"{ctx['moe_rows']} rows", **d)
    say("timing", scope="K1 at B=16 by batch tile, per call",
        **k1_batch_tiles(gen))
    say("timing", scope="one paged decode step's KV copies, 4 slots",
        **kv_copies(gen))
    say("timing", scope="Algorithm 1 compile, full width",
        adaptive_compile_s=ctx["adaptive_compile_s"],
        search_k1_launches=ctx["k1_launches"],
        k1_device_ms_in_compile=ctx["k1_compile"]["k1_device_ms"],
        all_kernels_device_ms_in_compile=ctx["k1_compile"][
            "all_kernels_device_ms"],
        profiled_compile_s=ctx["k1_compile"]["profiled_compile_s"])

    def err(kernel):
        return max(r["max_abs_err"] for r in rows if r["kernel"] == kernel)
    hybrid = {"fused_spec_crossbar": ctx.get("jamba_k2"),
              "centered_int8_matmul": ctx.get("jamba_k3"),
              "fused_crossbar": ctx.get("jamba_k1")}
    for name, d in hybrid.items():
        if d is not None:
            say("timing", kernel=name, scope=f"{JAMBA_ARCH} layer "
                f"{JAMBA_LAYER}, published widths" + (
                    ", Algorithm 1's search shape (16 rows, 6 matrices)"
                    if name == "fused_crossbar"
                    else f", one decode step, B={N_SLOTS}"), **d)
    moe_launches = {"fused_crossbar": ctx.get("moe_k1_launches"),
                    "fused_spec_crossbar": ctx.get("moe_k2_launches"),
                    "centered_int8_matmul": ctx.get("moe_k3_launches"),
                    "sliced_crossbar": 0}
    meta = {
        "fused_crossbar": ("fused_crossbar.cu", "fused_crossbar.py:104",
                           ctx["k1_launches"]),
        "fused_spec_crossbar": ("fused_spec_crossbar.cu",
                                "fused_spec_crossbar.py:139",
                                ctx["k2_launches"]),
        "centered_int8_matmul": ("centered_int8_matmul.cu",
                                 "int8_matmul.py:51", ctx["k3_launches"]),
        # no caller under src/: never launched on a served path
        "sliced_crossbar": ("sliced_crossbar.cu", "sliced_crossbar.py:65",
                            0)}
    out = []
    for name, d, _ in table:
        if d is k2a or d is k4_64:  # the kernels line keeps one row each
            continue
        src, rep, launches = meta[name]
        out.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{src}",
            replaces=f"src/repro/kernels/{rep}", launches=launches,
            max_abs_err=err(name), ms=d["ms"], plain_ms=d["plain_ms"],
            bound_ms=d["bound_ms"], bound_by=d["bound_by"],
            library_ms=d["library_ms"]))
        if d is k4:  # and K4 at B = 64, where operations bound it
            out[-1].update({f"b64_{k}": k4_64[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
        if moe_launches[name] is not None:  # the MoE path's own run
            m = moe.get(name) or {}
            out[-1].update(
                moe_launches=moe_launches[name],
                moe_max_abs_err=max(
                    (r["max_abs_err"] for r in rows if r["kernel"] == name
                     and str(r.get("site", "")).startswith(MOE_ARCH)),
                    default=None), moe_ms=m.get("ms"),
                moe_plain_ms=m.get("plain_ms"),
                moe_bound_ms=m.get("bound_ms"),
                moe_bound_by=m.get("bound_by"),
                moe_library_ms=m.get("library_ms"))
        if "hybrid_launches" in ctx:  # the hybrid phase's own runs
            h = hybrid.get(name) or {}
            out[-1].update(
                hybrid_launches=ctx["hybrid_launches"].get(name, 0),
                hybrid_max_abs_err=max(
                    (r["max_abs_err"] for r in rows if r["kernel"] == name
                     and str(r.get("site", "")).startswith(
                         (RWKV_ARCH, JAMBA_ARCH))), default=None),
                hybrid_ms=h.get("ms"), hybrid_plain_ms=h.get("plain_ms"),
                hybrid_bound_ms=h.get("bound_ms"),
                hybrid_bound_by=h.get("bound_by"),
                hybrid_library_ms=h.get("library_ms"))
        if "disagg_launches" in ctx:  # the disagg phase's two ranks
            out[-1].update(
                disagg_launches=ctx["disagg_launches"].get(name, 0),
                disagg_max_abs_err=max(
                    (r["max_abs_err"] for r in rows if r["kernel"] == name
                     and str(r.get("site", "")).startswith("disagg")),
                    default=None))
        if "examples_launches" in ctx:  # the examples' subprocesses
            out[-1]["examples_launches"] = ctx["examples_launches"][name]
        if "paper_launches" in ctx:  # the paper phase's artifacts
            p = ctx["paper_kernels"].get(name)
            b = p and bound(p["bytes"], p["ops"])
            out[-1].update(
                paper_launches=ctx["paper_launches"][name],
                paper_max_abs_err=max(
                    (r["max_abs_err"] for r in rows if r["kernel"] == name
                     and str(r.get("site", "")).startswith("paper")),
                    default=None),
                paper_ms=p and p["ms"], paper_plain_ms=p and p["plain_ms"],
                paper_bound_ms=b and b["bound_ms"],
                paper_bound_by=b and b["bound_by"], paper_library_ms=None)
        for key, archs in (("encoder", ENCODER_ARCHS),  # the phases' runs
                           ("decoders", tuple(d[0] for d in DECODERS))):
            if f"{key}_kernels" not in ctx:
                continue
            e = ctx[f"{key}_kernels"].get(name)
            b = e and bound(e["bytes"], e["ops"])
            out[-1].update({
                f"{key}_launches": e["launches"] if e else 0,
                f"{key}_max_abs_err": max(
                    (r["max_abs_err"] for r in rows if r["kernel"] == name
                     and str(r.get("site", "")).startswith(archs)),
                    default=None),
                f"{key}_ms": e and e["ms"],
                f"{key}_bound_ms": b and b["bound_ms"],
                f"{key}_bound_by": b and b["bound_by"],
                f"{key}_library_ms": e and e["library_ms"]})
    return out


# ---------------------------------------------------------------- nonideal
DIE_RUNS = (("nominal", 0), ("1sigma", 0), ("1sigma", 0), ("1sigma", 1),
            ("3sigma", 0))   # (corner, die seed): 1-sigma seed 0 twice
DIE_NEW_TOKENS = 3  # per request on a die: its prefill's and 2 decode steps'
NOISE_LEVELS = (0.04, 0.08, 0.12)


def phase_nonideal(ctx: dict) -> None:
    """qwen1.5-0.5b served whole on ``NonidealSim`` dies at the paper's 7b
    ADC (the serve phase's weights, pinned exact plans and 4 requests,
    ``DIE_NEW_TOKENS`` new tokens each): the nominal die's tokens and every crossbar call of a decode step equal the
    ideal array's with speculation off (K1) bit for bit; the 1-sigma die
    twice with one seed gives one set of tokens; the output-code error
    rises with the corner; the fault and program-error statistics of the
    largest planes; the float32 read against float64; the ADC noise model
    on the FFN up projection and Algorithm 1 under noise; the step's
    program and read device time, its wall time and peak memory; the
    launcher's ``--device-corner``."""
    import dataclasses
    import torch
    from repro_torch.core import backends as bk
    from repro_torch.serve import ContinuousServeEngine
    t_phase = time.perf_counter()
    q = ctx["qwen"]
    params, reqs, max_len = q["params"], q["reqs"], q["max_len"]
    die_reqs = [dataclasses.replace(r, max_new_tokens=DIE_NEW_TOKENS)
                for r in reqs]
    plans = ctx["exact_compiled"].plans
    at7 = dataclasses.replace(q["cfg"], pim_mode="exact", pim_adc_bits=7)
    vocab = at7.vocab_size
    base = torch.cuda.memory_allocated()
    checked = []

    def serve(run, cfg, per_call):
        eng = ContinuousServeEngine(cfg, params, n_slots=N_SLOTS,
                                    max_len=max_len, prefill_chunk=64,
                                    plans=plans)
        torch.cuda.reset_peak_memory_stats()
        outs, serve_s, launches = drive(eng, die_reqs)
        row = engine_row(run, eng, outs, serve_s, launches, per_call, vocab,
                         n_new=DIE_NEW_TOKENS)
        row["peak_gib"] = peak_gb(base)
        return [o.tokens.tolist() for o in outs], row

    # 1. the ideal array with speculation off (K1 on every projection),
    # then the dies (no kernel: engine_row checks 0 launches)
    ideal, row = serve("ideal-nospec-7b",
                       dataclasses.replace(at7, pim_speculation=False),
                       PER_CALL["exact-nospec"])
    say("nonideal", **row)
    ideal_step_ms = row["step_ms"]
    flat_ideal = [t for r in ideal for t in r]
    tokens, steps = {}, {}
    for corner, seed in DIE_RUNS:
        cfg = dataclasses.replace(at7, pim_crossbar_backend="nonideal",
                                  pim_device_corner=corner,
                                  pim_device_seed=seed)
        got, row = serve(f"die-{corner}-seed{seed}", cfg, {})
        flat = [t for r in got for t in r]
        share = sum(a == b for a, b in zip(flat, flat_ideal)) / len(flat)
        if (corner, seed) in tokens and tokens[(corner, seed)] != got:
            raise AssertionError(f"{corner} seed {seed} served twice gave "
                                 f"{tokens[(corner, seed)]} and {got}")
        tokens[(corner, seed)] = got
        steps.setdefault(corner, []).append(row["step_ms"])
        say("nonideal", **row, share_equal_ideal=round(share, 4),
            first_tokens=json.dumps(got[0]))
    if tokens[("nominal", 0)] != ideal:
        raise AssertionError(f"nominal die tokens {tokens[('nominal', 0)]} "
                             f"!= the ideal spec-off tokens {ideal}")
    checked += ["nominal die tokens == ideal spec-off (K1) tokens",
                "1sigma seed 0 twice: equal tokens", "dies launch no kernel"]

    # 2. the zero-corner contract at full width: every crossbar call of one
    # decode step, the nominal die's loop against K1
    say("nonideal", **zero_corner_step(at7, plans))
    checked.append("338 calls: nominal die psum and saturations == K1")

    # 3. output-code error of one decode step's head and FFN up inputs
    say("nonideal", **die_code_errors(at7, params, plans, reqs, max_len))
    checked.append("code error rises nominal (0 at 24b) < 1sigma < 3sigma")

    # 4. statistics of the largest planes, the padding contracts, the
    # float32 read
    say("nonideal", **die_statistics(at7, plans))
    checked += ["stuck count within 6 sd", "no faults on padding rows",
                "std(log G/G0) within 5% of program_sigma",
                "padded plane stays zero", "float32 read vs float64 <= 1e-5"]

    # 5. the ADC noise model and Algorithm 1 under noise
    say("nonideal", **adc_noise_checks(params, plans))
    checked += ["noise 0 with a key == K2", "one key, one psum",
                "error rises with noise, spec on and off",
                "Algorithm 1: noise 0.10 takes no fewer slices"]

    # 6. device time of the program and the reads in one decode step
    say("nonideal", scope="1sigma die, one decode step's 338 calls",
        die_step_ms=json.dumps(steps["1sigma"]),
        ideal_nospec_step_ms=ideal_step_ms,
        **die_device_time(at7, plans, bk.make("nonideal", "1sigma")))

    # 7. the launcher on a die
    say("nonideal", **launcher_on_a_die())
    checked.append("launcher --device-corner 1sigma serves")
    say("nonideal", ok=True, phase_s=round(time.perf_counter() - t_phase, 1),
        checked=json.dumps(checked))


def site_plan(cfg, leaf):
    """A compiled exact leaf as the model runs it (``PimPlan``)."""
    from repro_torch.models import layers as L
    return L._plan_to_pim_plan(leaf, cfg, rows=leaf["w_q"].shape[0])


def zero_corner_step(cfg, plans: dict) -> dict:
    """Each of one decode step's crossbar calls (every projection, both
    signed passes, 4 rows of random codes 0..127) through the nominal
    die's loop and through K1, psum and saturation count ``==``."""
    import torch
    from repro_torch.core import backends as bk
    from repro_torch.core import crossbar as xbar
    die = bk.make("nonideal", "nominal")
    gen = torch.Generator(device="cuda").manual_seed(24)
    n = sats = 0
    for name, leaf, B in step_calls(cfg, plans):
        pp = site_plan(cfg, leaf)
        for _ in range(2):  # the two signed passes
            x = torch.randint(0, 128, (B, pp.enc.rows), generator=gen,
                              device="cuda", dtype=torch.int32)
            want, wst = xbar.forward(x, pp.enc, ONE_BIT, pp.adc)
            got, gst = xbar.forward(x, pp.enc, ONE_BIT, pp.adc, device=die)
            s_want, s_got = int(wst.saturations), int(gst.saturations)
            if not torch.equal(got, want) or s_got != s_want:
                raise AssertionError(f"nominal die != K1 at {name}: "
                                     f"saturations {s_got} vs {s_want}")
            n += 1
            sats += s_want
    if n != 2 * len(step_calls(cfg, plans)):
        raise AssertionError(f"{n} calls compared")
    return dict(zero_corner="nominal die loop == K1", calls_compared=n,
                tolerance=0, saturations=sats)


def die_code_errors(cfg, params, plans, reqs, max_len) -> dict:
    """The inputs of one decode step (4 prompts cut to 8 tokens,
    prefilled, then one greedy step) at the LM head and the first FFN up
    projection, recorded at ``layers.pim_matmul``; each layer prepared on
    them (``pim_linear.prepare``, calibrated output scale) and run on the
    nominal, 1-sigma and 3-sigma dies, 1b input slices: the mean |8b
    output-code error| on nonzero expected outputs against
    ``forward_int_reference`` (``adaptive._error_value``'s measure), at
    the 24b ADC (nominal must be 0) and at 7b. Must rise with the corner
    at 24b."""
    import dataclasses
    import torch
    from repro_torch.core import adc as adc_lib
    from repro_torch.core import backends as bk
    from repro_torch.core import pim_linear as pl
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    seen = []
    orig = L.pim_matmul

    def record(x, w, plan, c):
        seen.append((x.reshape(-1, x.shape[-1]).float(), w.float()))
        return orig(x, w, plan, c)

    toks = torch.tensor([r.prompt[:8].tolist() for r in reqs],
                        device="cuda")
    with torch.no_grad():
        logits, state = T.prefill(params, cfg, toks, max_len=max_len,
                                  plans=plans)
        nxt = logits[:, -1:].argmax(-1)
        L.pim_matmul = record
        try:
            T.decode_step(params, cfg, state, nxt, plans=plans)
        finally:
            L.pim_matmul = orig
    d, f = cfg.d_model, cfg.d_ff
    sites = {"head": next(s for s in seen if s[1].shape[1] == cfg.vocab_size),
             "ffn_up": next(s for s in seen if s[1].shape == (d, f))}
    out = {}
    for bits in (24, 7):
        for site, (x, w) in sites.items():
            plan = pl.prepare(w, x, speculation=False,
                              adc=adc_lib.ADCConfig(bits=bits))
            ref = pl.output_codes(pl.forward_int_reference(x, plan), plan)
            nz = ref != 0
            errs = []
            for corner in ("nominal", "1sigma", "3sigma"):
                die = dataclasses.replace(plan, device=bk.make("nonideal",
                                                               corner))
                got = pl.output_codes(pl.forward_exact(x, die), plan)
                err = torch.where(nz, (got - ref).abs().float(), 0.0).sum()
                errs.append(float(err / nz.sum().clamp_min(1)))
            out[f"{site}_{bits}b"] = json.dumps([round(e, 4) for e in errs])
            if bits == 24 and not errs[0] == 0.0 < errs[1] < errs[2]:
                raise AssertionError(f"{site} code error at 24b {errs}")
    return dict(code_error="nominal,1sigma,3sigma", rows=len(reqs), **out)


def die_statistics(cfg, plans: dict) -> dict:
    """The 1-sigma die (seed 0) on the two largest plane sets: the head
    (3 x 2 x 512 x 151936 devices per array) and the down projection (R =
    2816, padded to 3072 rows): the stuck count against its binomial mean
    (within 6 sd), no fault on padding rows, std(log G/G0) over live,
    non-stuck, nonzero devices within 5% of ``program_sigma``; a padded
    all-zero plane on the down projection stays zero at 3-sigma; one read
    of the head at 3-sigma against a float64 recomputation of the same
    programmed planes (relative error <= 1e-5; TF32 would show ~1e-3)."""
    import torch
    from repro_torch.core import backends as bk
    head = site_plan(cfg, plans["head"]).enc
    down = site_plan(cfg, plans["layers"][0]["ffn"]["w2"]).enc
    out = {}
    sigma1 = bk.make("nonideal", "1sigma")
    c = bk.SIGMA1
    for site, enc in (("head", head), ("down", down)):
        prog = sigma1.program(enc.planes, rows=enc.rows)
        n_w, n_seg, R, C = enc.planes.shape
        stuck = prog.stuck_on | prog.stuck_off  # (2, n_w, n_seg, R, C)
        n = 2 * n_w * enc.rows * C
        mean = n * c.stuck_rate
        sd = math.sqrt(n * c.stuck_rate * (1 - c.stuck_rate))
        count = int(stuck.sum())
        if abs(count - mean) >= 6 * sd:
            raise AssertionError(f"{site}: {count} stuck, mean {mean}")
        pad = int(stuck.reshape(2, n_w, n_seg * R, C)[:, :, enc.rows:].sum())
        if pad:
            raise AssertionError(f"{site}: {pad} faults on padding rows")
        ideal = bk.IDEAL.program(enc.planes)
        sums = torch.zeros(2, dtype=torch.float64, device="cuda")
        n_dev = 0
        for i, (g, g0) in enumerate(((prog.gp, ideal.gp), (prog.gn,
                                                           ideal.gn))):
            keep = (g0 > 0) & ~stuck[i]
            lg = torch.log(g[keep] / g0[keep].float()).double()
            sums += torch.stack([lg.sum(), (lg * lg).sum()])
            n_dev += lg.numel()
            del keep, lg
        m = sums[0] / n_dev
        std = float(torch.sqrt(sums[1] / n_dev - m * m))
        if abs(std / c.program_sigma - 1) > 0.05:
            raise AssertionError(f"{site}: std(log G/G0) {std}")
        out.update({f"{site}_stuck": count, f"{site}_stuck_mean": mean,
                    f"{site}_stuck_sd": round(sd, 1),
                    f"{site}_padding_faults": pad,
                    f"{site}_std_log_g": round(std, 6),
                    f"{site}_devices_in_std": n_dev})
        del prog, stuck, ideal
    padded = torch.cat([down.planes, torch.zeros_like(down.planes[:1])])
    prog = bk.make("nonideal", "3sigma").program(padded, rows=down.rows)
    if prog.gp[-1].any() or prog.gn[-1].any():
        raise AssertionError("a padded plane grew conductance at 3sigma")
    if not prog.stuck_on[:, -1].any():
        raise AssertionError("no fault drawn on the padded plane")
    del prog
    die3 = bk.make("nonideal", "3sigma")
    prog = die3.program(head.planes, rows=head.rows)
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randint(0, 2, (N_SLOTS, head.n_segments, head.rows_per_xbar),
                      generator=gen, device="cuda", dtype=torch.int32)
    rel = 0.0
    for j in range(head.n_slices):
        pos, neg = die3.read(prog, x, j)
        x64 = x.double().transpose(0, 1)
        for got, g in ((pos, prog.gp[j]), (neg, prog.gn[j])):
            want = torch.bmm(x64, g.double()).transpose(0, 1)
            rel = max(rel, float((got.double() - want).abs().max()
                                 / want.abs().max()))
    if rel > 1e-5:
        raise AssertionError(f"float32 read off float64 by {rel}")
    del prog
    torch.cuda.empty_cache()
    return dict(statistics="1sigma seed 0", **out,
                padded_plane_zero_at_3sigma=True,
                read_rel_err_vs_float64=rel, read_tolerance=1e-5)


def adc_noise_checks(params, plans: dict) -> dict:
    """The ADC noise model on the first FFN up projection (1024 x 2816)
    prepared on 64 rows of seeded normal activations at the 7b ADC:
    noise 0 with a key is the K2 route bit for bit; one key gives one
    psum and another key another; the output-code error rises over the
    noise levels with speculation on (the noisy speculation loop) and off
    (the noisy static loop); Algorithm 1 at noise 0.10 picks no fewer
    slices than at 0 (``test_noise_pushes_to_more_slices``)."""
    import dataclasses
    import torch
    from repro_torch.core import adaptive as ad
    from repro_torch.core import adc as adc_lib
    from repro_torch.core import pim_linear as pl
    from repro_torch.core import rng
    from repro_torch.kernels import ops
    w = params["layers"][0]["ffn"]["w1"].float()
    gen = torch.Generator(device="cuda").manual_seed(64)
    x = torch.randn(64, w.shape[0], generator=gen, device="cuda")
    plan = pl.prepare(w, x, adc=adc_lib.ADCConfig(bits=7))
    ops.reset_launch_counts()
    y0 = pl.forward_exact(x, plan)
    y0k = pl.forward_exact(x, plan, noise_level=0.0, key=rng.Key(0))
    k2 = ops.launch_counts()["fused_spec_crossbar"]
    if not torch.equal(y0, y0k) or k2 != 4:
        raise AssertionError(f"noise 0 with a key != K2 ({k2} launches)")
    a = pl.forward_exact(x, plan, noise_level=0.08, key=rng.Key(1))
    b = pl.forward_exact(x, plan, noise_level=0.08, key=rng.Key(1))
    c = pl.forward_exact(x, plan, noise_level=0.08, key=rng.Key(2))
    if not torch.equal(a, b) or torch.equal(a, c):
        raise AssertionError("one key must give one result, two keys two")
    ref = pl.output_codes(pl.forward_int_reference(x, plan), plan)
    nz = ref != 0
    out = {}
    for spec_on in (True, False):
        p = dataclasses.replace(plan, speculation=spec_on)
        errs = []
        for noise in (0.0,) + NOISE_LEVELS:
            y = pl.forward_exact(x, p, noise_level=noise, key=rng.Key(7))
            err = torch.where(nz, (pl.output_codes(y, p) - ref).abs()
                              .float(), 0.0).sum() / nz.sum().clamp_min(1)
            errs.append(float(err))
        if not errs[1] < errs[2] < errs[3]:
            raise AssertionError(f"noise error spec={spec_on}: {errs}")
        out["code_error_spec" if spec_on else "code_error_static"] = \
            json.dumps([round(e, 4) for e in errs])
    clean = ad.find_best_slicing(w, x)
    noisy = ad.find_best_slicing(w, x, noise_level=0.10, key=rng.Key(0))
    if noisy.n_slices < clean.n_slices:
        raise AssertionError(f"noise 0.10 chose {noisy.slicing}, "
                             f"noise 0 {clean.slicing}")
    return dict(adc_noise="ffn up 1024x2816, 64 rows, 7b",
                noise_levels=json.dumps((0.0,) + NOISE_LEVELS), **out,
                slicing_noise0="-".join(map(str, clean.slicing)),
                slicing_noise010="-".join(map(str, noisy.slicing)),
                error_noise010=round(noisy.error, 4))


def die_device_time(cfg, plans: dict, die) -> dict:
    """Device time of one decode step's programming and reads on ``die``:
    each distinct projection shape's ``program`` and one signed pass of
    reads (one read per plane of the 8 one-bit input slices stacked, 4
    rows each, as ``crossbar.forward`` reads), timed with CUDA events
    (``cuda_ms``, 3 calls each) and multiplied by the calls a step makes
    of it (two passes per projection); with the bytes the reads must move
    and their bound. (``torch.profiler``'s kernel sums of these calls
    came out below what the programming must move, or empty; PERF.md
    has the runs.)"""
    import collections
    import torch
    calls = step_calls(cfg, plans)
    per_shape = collections.Counter()
    leaf_of = {}
    for _, leaf, _ in calls:
        key = tuple(leaf["planes"].shape)
        per_shape[key] += 2
        leaf_of.setdefault(key, leaf)
    program_ms = read_ms = 0.0
    read_bytes = program_devices = 0
    for key, n in per_shape.items():
        enc = site_plan(cfg, leaf_of[key]).enc
        x = torch.randint(0, 2, (8 * N_SLOTS, enc.n_segments,
                                 enc.rows_per_xbar), device="cuda",
                          dtype=torch.int32)
        prog = die.program(enc.planes, rows=enc.rows)

        def program():
            die.program(enc.planes, rows=enc.rows)

        def reads():
            for j in range(enc.n_slices):
                die.read(prog, x, j)

        program_ms += n * cuda_ms(program, reps=3)
        read_ms += n * cuda_ms(reads, reps=3)
        program_devices += n * enc.planes.numel()
        read_bytes += n * 8 * 2 * 4 * enc.planes.numel()
        del prog
    torch.cuda.empty_cache()
    return dict(program_device_ms=round(program_ms, 3),
                read_device_ms=round(read_ms, 3),
                devices_programmed=program_devices,
                read_gb=round(read_bytes / 1e9, 1),
                read_bound_ms=round(1e3 * read_bytes / HBM_BYTES_PER_S, 3))


def launcher_on_a_die() -> dict:
    """``python -m repro_torch.launch.serve --arch qwen1.5-0.5b --pim
    exact --device-corner 1sigma`` in-process, one request of up to 2
    tokens (a die's engine call takes seconds): it names the die and
    serves."""
    import contextlib
    import io
    from repro_torch.launch import serve as launch
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        launch.main(["--arch", ARCH, "--pim", "exact", "--device-corner",
                     "1sigma", "--requests", "1", "--steps", "2"])
    text = buf.getvalue()
    line = "device corner: 1sigma (die seed 0, nonideal ReRAM array)"
    if line not in text or "first outputs:" not in text:
        raise AssertionError(f"launcher output: {text[-400:]}")
    served = next(ln for ln in text.splitlines() if " continuous on " in ln)
    return dict(launcher="--pim exact --device-corner 1sigma",
                launch_s=round(time.perf_counter() - t0, 3), served=served)


# ---------------------------------------------------------------- paper
# The paper artifacts whose inputs come from numpy or from no random
# source, as the reference (benchmarks/, commit f81f836) computes them on
# the CPU (JAX_PLATFORMS=cpu); the card must reproduce them exactly.
PAPER_RECORDED = json.loads("""
{"table1_slicing":[{"case":"unsliced","bits_per_mac":4,"converts_per_mac":1,
"cycles":1,"columns":1},{"case":"input-sliced","bits_per_mac":2,
"converts_per_mac":2,"cycles":2,"columns":1},{"case":"weight-sliced",
"bits_per_mac":2,"converts_per_mac":2,"cycles":1,"columns":2},{"case":
"both-sliced","bits_per_mac":1,"converts_per_mac":4,"cycles":2,"columns":
2}],"fig3_column_sums":{"baseline_unsigned_4b":{"le7b":0.0,"p999_bits":15},
"center_offset":{"le7b":0.516845703125,"p999_bits":13},"adaptive_slicing":{
"le7b":0.6712239980697632,"p999_bits":11},"speculation_cycles":{"le7b":
0.9308810830116272,"p999_bits":9},"recovery_cycles":{"le7b":1.0,"p999_bits":
7},"final_saturation_rate":0.0716145858168602},"table2_titanium":{
"isaac-8b":{"energy_per_convert_pJ":2.58,"converts_per_mac":
0.2627262682862083,"macs":2854522880,"mean_row_utilization":
0.9630474607371162,"adc_energy_uJ":1934.8920115199999,"titanium_law_uJ":
1934.8920115199999,"law_matches":true},"raella":{"energy_per_convert_pJ":
1.29,"converts_per_mac":0.023436200952784095,"macs":2854522880,
"mean_row_utilization":0.7938780684777696,"adc_energy_uJ":86.2999316736,
"titanium_law_uJ":86.2999316736,"law_matches":true}},"fig12_efficiency":{
"resnet18":{"efficiency_x":4.686660182100039,"throughput_x":
2.844919786096257,"nospec_efficiency_x":4.330298990131172,
"nospec_throughput_x":3.911764705882353},"resnet50":{"efficiency_x":
4.677161805800745,"throughput_x":3.43801652892562,"nospec_efficiency_x":
4.377330359421561,"nospec_throughput_x":4.7272727272727275},"googlenet":{
"efficiency_x":4.573913742338427,"throughput_x":2.683385579937304,
"nospec_efficiency_x":4.198544467600309,"nospec_throughput_x":
3.6896551724137927},"inception_v3":{"efficiency_x":4.3206123749274745,
"throughput_x":2.4592702535559683,"nospec_efficiency_x":4.0539062138810795,
"nospec_throughput_x":3.381496598639456},"mobilenet_v2":{"efficiency_x":
2.681811580271821,"throughput_x":0.9171938304072784,"nospec_efficiency_x":
1.9544805443805098,"nospec_throughput_x":1.2611415168100077},
"shufflenet_v2":{"efficiency_x":3.2597474016820214,"throughput_x":
0.7272727272727273,"nospec_efficiency_x":2.570442731327005,
"nospec_throughput_x":1.0},"bert_large":{"efficiency_x":3.2852809154951252,
"throughput_x":3.2727272727272725,"nospec_efficiency_x":3.056797326445982,
"nospec_throughput_x":4.5},"geomean":{"efficiency_x":3.8457455905933333,
"throughput_x":2.0276397437257527,"nospec_efficiency_x":3.3717699950714843,
"nospec_throughput_x":2.788004647622909,"paper":
"3.9 / 2.0 (nospec 2.8 / 2.7)"}},"fig13_retrain":{"forms8_vs_isaac":{
"efficiency_x":1.8959011648082733,"throughput_x":0.945012237138888,
"retrains":true},"timely_vs_isaac":{"efficiency_x":2.5,"retrains":true,
"note":"published 10x is vs original 16b ISAAC; 8b-ISAAC is ~4x that"},
"raella_vs_isaac":{"efficiency_x":4.681908585233747,"throughput_x":
3.1274400470778763,"retrains":false},"claim":
""
},"fig14_ablation":{"isaac-8b":{"ideal_converts_per_mac":0.25,
"measured_converts_per_mac":0.2627,"energy_vs_isaac":1.0,"adc_share":0.514},
"center-offset":{"ideal_converts_per_mac":0.0625,
"measured_converts_per_mac":0.0791,"energy_vs_isaac":3.66,"adc_share":
0.283},"center-adaptive":{"ideal_converts_per_mac":0.0469,
"measured_converts_per_mac":0.0593,"energy_vs_isaac":4.33,"adc_share":
0.251},"raella":{"ideal_converts_per_mac":0.0185,
"measured_converts_per_mac":0.0234,"energy_vs_isaac":4.69,"adc_share":
0.107}},"lm_on_pim":{"phi3.5-moe-42b":{"pim_layers":1665,"macs_per_token":
6506676224,"raella_converts_per_mac":0.0387,"efficiency_vs_isaac_x":3.41,
"raella_uJ_per_token":2236.09},"llama4-maverick-400b":{"pim_layers":9481,
"macs_per_token":10094182400,"raella_converts_per_mac":0.0434,
"efficiency_vs_isaac_x":3.05,"raella_uJ_per_token":3882.05},
"jamba-1.5-large-398b":{"pim_layers":2062,"macs_per_token":93054304256,
"raella_converts_per_mac":0.0374,"efficiency_vs_isaac_x":3.55,
"raella_uJ_per_token":30661.44},"qwen1.5-110b":{"pim_layers":561,
"macs_per_token":109962067968,"raella_converts_per_mac":0.0377,
"efficiency_vs_isaac_x":3.52,"raella_uJ_per_token":36613.27},"yi-6b":{
"pim_layers":225,"macs_per_token":5798625280,"raella_converts_per_mac":0.04,
"efficiency_vs_isaac_x":3.3,"raella_uJ_per_token":2062.37},"qwen2.5-32b":{
"pim_layers":449,"macs_per_token":31984189440,"raella_converts_per_mac":
0.0385,"efficiency_vs_isaac_x":3.43,"raella_uJ_per_token":10933.39},
"qwen1.5-0.5b":{"pim_layers":169,"macs_per_token":463863808,
"raella_converts_per_mac":0.0582,"efficiency_vs_isaac_x":2.24,
"raella_uJ_per_token":245.18},"hubert-xlarge":{"pim_layers":337,
"macs_per_token":1258936320,"raella_converts_per_mac":0.0426,
"efficiency_vs_isaac_x":3.31,"raella_uJ_per_token":450.85},"rwkv6-3b":{
"pim_layers":225,"macs_per_token":2684354560,"raella_converts_per_mac":
0.0412,"efficiency_vs_isaac_x":3.18,"raella_uJ_per_token":993.12},
"chameleon-34b":{"pim_layers":337,"macs_per_token":33755758592,
"raella_converts_per_mac":0.038,"efficiency_vs_isaac_x":3.49,
"raella_uJ_per_token":11331.48},"geomean_efficiency_x":3.22}}""")
PAPER_RECORDED["fig13_retrain"]["claim"] = (
    "RAELLA efficiency >= both retraining architectures and throughput ~ "
    "FORMS, with no retraining: 4.68x vs FORMS 1.90x / TIMELY 2.50x")
# each entry's run at its full default kwargs, but the die sweeps over
# every corner; the kernels each must launch (a die runs none)
PAPER_KWARGS = {"table4_corners": dict(corners=("nominal", "1sigma",
                                                "3sigma"))}
PAPER_LAUNCHES = {"fig3_column_sums": ("fused_spec_crossbar",),
                  "table4_accuracy": ("fused_crossbar",
                                      "fused_spec_crossbar"),
                  "fig15_noise": ("fused_crossbar", "fused_spec_crossbar"),
                  "fig15_corners": ("fused_crossbar",),
                  "compile_report": ("fused_crossbar",)}
# K1, K2 and K4 at segments other than 512 rows: (B, R, C, n_j), R
# counted in segments; a ragged last segment where it ends in -40 rows,
# C = 8 and 72 take the word-load path, R = 4 segments with C = 1008 the
# cp.async path; B = 2048 is Fig. 15's evaluation batch
SHORT_CASES = ((17, (3, -40), 72, 4), (4, (5, 0), 8, 3),
               (2048, (2, 0), 8, 4), (3, (4, 0), 1008, 3))


def record_calls(log: dict, entry: list):
    """Wrap K1's and K2's launchers so that each call on operands not seen
    before keeps a copy of them in ``log``, under the entry that made it
    (``entry[0]``); returns the undo. A call is known by a digest of every
    operand's contents, the slice tables, the segment length and the ADC
    window, so calls of one shape on other data (Table 4's Zero+Offset
    plan after its Center+Offset one, Algorithm 1 on each site) are kept
    apart and a repeat of the same call is not."""
    import hashlib
    import torch
    from repro_torch.kernels import fused_crossbar as fx
    from repro_torch.kernels import fused_spec_crossbar as fs
    saved = {}
    for name, mod in (("fused_crossbar", fx), ("fused_spec_crossbar", fs)):
        saved[mod] = orig = mod.launch

        def launch(*args, _orig=orig, _name=name, **kw):
            h = hashlib.blake2b(repr((_name, sorted(kw.items()))).encode(),
                                digest_size=16)
            for a in args:
                if isinstance(a, torch.Tensor):
                    h.update(repr((a.dtype, tuple(a.shape))).encode())
                    h.update(a.cpu().numpy().tobytes())
                else:
                    h.update(repr(a).encode())
            if h.digest() not in log:
                log[h.digest()] = entry[0], _name, tuple(
                    a.clone() if isinstance(a, torch.Tensor) else a
                    for a in args), dict(kw)
            return _orig(*args, **kw)
        mod.launch = launch
    return lambda: [setattr(m, "launch", f) for m, f in saved.items()]


def phase_paper(ctx: dict, rows: list) -> None:
    """The paper's tables and figures through ``repro_torch.paper``, every
    ``ENTRIES`` item at its full default kwargs on the card (the die
    sweeps over all three corners), launches counted per entry; the
    scripts' own asserts hold, the deterministic artifacts equal
    ``PAPER_RECORDED``; then every distinct K1 and K2 call the artifacts
    made, and K1, K2 and K4 at 128-384-row segments, held bit for bit."""
    import torch
    from repro_torch import paper
    from repro_torch.kernels import ops
    log: dict = {}
    entry = [None]
    undo = record_calls(log, entry)
    results, launches = {}, dict.fromkeys(ops.KERNELS, 0)
    try:
        for name, e in paper.ENTRIES.items():
            entry[0] = name
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            out = e.run(device="cuda", **PAPER_KWARGS.get(name, {}))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = ops.launch_counts()
            for k, v in counts.items():
                launches[k] += v
            results[name] = out = json.loads(json.dumps(out))
            if {k for k, v in counts.items() if v} != set(
                    PAPER_LAUNCHES.get(name, ())):
                raise AssertionError(f"paper {name}: launches {counts}")
            if name in PAPER_RECORDED and out != PAPER_RECORDED[name]:
                say("paper", entry=name, result=json.dumps(out))
                raise AssertionError(f"paper {name} differs from the "
                                     "reference's recorded values")
            say("paper", entry=name, seconds=round(secs, 3),
                headline=json.dumps(e.derive(out)),
                launches=json.dumps({k: v for k, v in counts.items()
                                     if v}),
                recorded=name in PAPER_RECORDED, result=json.dumps(
                    {k: (len(v) if k == "sites" else v)
                     for k, v in out.items()} if isinstance(out, dict)
                    else out))
    finally:
        undo()
    # the zero-corner contract at full size: the nominal die reads what
    # the ideal array (K1) reads, so it scores what Fig. 15's adaptive arm
    # scores at noise 0 on the same plan
    nominal = results["fig15_corners"]["corner_nominal"]["accuracy"]
    if nominal != results["fig15_noise"]["noise_0.00"]["adaptive"]:
        raise AssertionError("nominal die != ideal array on Fig. 15's plan")
    for name in ("table4_accuracy", "fig15_noise", "fig15_corners",
                 "table4_corners"):
        accs = leaf_values(results[name])
        if not accs or not all(0.0 <= a <= 1.0 for a in accs):
            raise AssertionError(f"paper {name}: accuracies {accs}")
    ctx["paper_launches"] = launches
    ctx["paper_kernels"] = paper_calls(log, rows)
    check_short_segments(rows, torch.Generator(device="cuda").manual_seed(3))
    say("paper", ok=True, entries=len(results),
        launches=json.dumps(launches),
        distinct_calls=len(log),
        kernel_checks=len([r for r in rows if str(r.get("site", ""))
                           .startswith("paper")]))


def leaf_values(tree) -> list:
    """Every accuracy in an artifact's result: the float model's, each
    encoding's or corner's, each of Fig. 15's arms."""
    keys = ("accuracy", "float_accuracy", "float_reference", "isaac",
            "center_offset", "adaptive", "raella")
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += leaf_values(v)
        elif k in keys:
            out.append(v)
    return out


def paper_calls(log: dict, rows: list) -> dict:
    """Each distinct K1 and K2 call the artifacts made (``record_calls``),
    on its recorded operands: kernel against plain version bit for bit
    (psum and counters), then timed beside its bound; returns per kernel
    the sums over the distinct calls. A row names the entry, the call's
    number among that entry's distinct calls of the kernel, and the
    plan's center (128 throughout for Zero+Offset, 0 for ISAAC's unsigned
    weights)."""
    from repro_torch.kernels import fused_crossbar as fx
    from repro_torch.kernels import fused_spec_crossbar as fs
    sums, seq = {}, {}
    for entry, kernel, args, kw in log.values():
        mod = fx if kernel == "fused_crossbar" else fs
        got = mod.launch(*args, **kw)
        x, w, mults, centers = args[0], args[1], args[4], args[-1]
        (B, R), (n_j, Rp, C), n_i = x.shape, w.shape, mults.shape[0]
        rx = kw.get("rows_per_xbar", 512)
        call = seq[entry, kernel] = seq.get((entry, kernel), -1) + 1
        c0 = int(centers.flatten()[0])
        counters = got[1:] if kernel == "fused_crossbar" else \
            (got[1].tolist(), int(got[2]))
        row = compare(kernel, got, mod.plain(*args, **kw),
                      site=f"paper.{entry}", call=call, B=B, R=R,
                      C=C, n_j=n_j, n_i=n_i, rows_per_xbar=rx,
                      center=c0 if bool((centers == c0).all())
                      else "per-column",
                      adc=f"[{kw.get('adc_lo')},{kw.get('adc_hi')}]",
                      counters=json.dumps([int(counters[0])]
                                          if kernel == "fused_crossbar"
                                          else counters))
        n_bytes = (4 * B * R + n_j * Rp * C + 4 * n_i * n_j
                   + 4 * (Rp // rx) * C + 4 * B * C
                   + 8 * (1 if kernel == "fused_crossbar" else n_i + 1))
        b = bound(n_bytes, 2 * B * R * C * n_j * 8)
        row.update(kernel_ms=cuda_ms(lambda: mod.launch(*args, **kw), 3),
                   plain_ms=cuda_ms(lambda: mod.plain(*args, **kw), 1,
                                    warmup=0),
                   bound_ms=b["bound_ms"], bound_by=b["bound_by"])
        rows.append(row)
        say("paper", **row)
        s = sums.setdefault(kernel, dict(ms=0.0, plain_ms=0.0, bytes=0,
                                         ops=0, calls=0))
        s["ms"] += row["kernel_ms"]
        s["plain_ms"] += row["plain_ms"]
        s["bytes"] += b["bytes"]
        s["ops"] += b["ops"]
        s["calls"] += 1
    for kernel, s in sums.items():
        say("paper", kernel=kernel, scope="every distinct call of the "
            "artifacts, once each", **{**s, **bound(s["bytes"], s["ops"])})
    return sums


def segment_operands(B: int, R: int, C: int, n_j: int, rows: int, lo: int,
                     gen):
    """Planes of ``rows``-row segments holding R rows (zero padding rows;
    values 0..15 for an unsigned ADC window, else -15..15), their shifts,
    codes 0..255 and centers 0..255."""
    import torch
    n_seg = -(-R // rows)
    planes = torch.randint(0 if lo == 0 else -15, 16, (n_j, n_seg, rows, C),
                           generator=gen, device="cuda", dtype=torch.int8)
    planes.view(n_j, n_seg * rows, C)[:, R:] = 0
    shifts = torch.tensor([6, 4, 2, 0, 1, 3, 5, 7][:n_j], dtype=torch.int32,
                          device="cuda")
    x = torch.randint(0, 256, (B, R), generator=gen, device="cuda",
                      dtype=torch.int32)
    centers = torch.randint(0, 256, (n_seg, C), generator=gen, device="cuda",
                            dtype=torch.int32)
    return x, planes, shifts, centers


def check_short_segments(rows: list, gen) -> None:
    """K1 (1b input slices, at the paper's 7b ADC and ISAAC's unsigned 8b
    one), K2 ((4,2,2) at 7b, failures and recovery saturations required)
    and K4 (int8 slices and planes, 24b and 7b) at segments of 128, 256
    and 384 rows over several segments (``SHORT_CASES``), bit for bit
    against the plain versions, psum and counters."""
    import torch
    from repro_torch.core import adc as adc_lib
    from repro_torch.kernels import fused_crossbar as fx
    from repro_torch.kernels import fused_spec_crossbar as fs
    from repro_torch.kernels import ops
    from repro_torch.kernels import sliced_crossbar as sx
    windows = {"7b": adc_lib.ADCConfig(bits=7),
               "u8b": adc_lib.ADCConfig(bits=8, signed=False),
               "24b": adc_lib.ADCConfig(bits=24)}
    for rx in (128, 256, 384):
        for B, (segs, extra), C, n_j in SHORT_CASES:
            R = segs * rx + extra
            site = f"paper.short{rx}"
            for adc_name in ("7b", "u8b"):
                adc = windows[adc_name]
                kw = dict(adc_lo=adc.lo, adc_hi=adc.hi, rows_per_xbar=rx)
                x, planes, shifts, centers = segment_operands(
                    B, R, C, n_j, rx, adc.lo, gen)
                args = (x, *ops.crossbar_tables(planes, shifts, ONE_BIT,
                                                rows_per_xbar=rx), centers)
                got = fx.launch(*args, **kw)
                rows.append(compare("fused_crossbar", got,
                                    fx.plain(*args, **kw), site=site, B=B,
                                    R=R, C=C, n_j=n_j, adc=adc_name,
                                    sats=int(got[1])))
                if not int(got[1]):
                    raise AssertionError(f"K1 at {rows[-1]} never clamped")
            adc = windows["7b"]
            kw = dict(adc_lo=adc.lo, adc_hi=adc.hi, rows_per_xbar=rx)
            x, planes, shifts, centers = segment_operands(B, R, C, n_j, rx,
                                                          adc.lo, gen)
            args = (x, *ops.spec_tables(planes, shifts, SPEC,
                                        rows_per_xbar=rx), centers)
            got = fs.launch(*args, **kw)
            rows.append(compare("fused_spec_crossbar", got,
                                fs.plain(*args, **kw), site=site, B=B, R=R,
                                C=C, n_j=n_j, adc="7b",
                                fails=got[1].tolist(), rsats=int(got[2])))
            if not (int(got[1].sum()) and int(got[2])):
                raise AssertionError(f"K2 at {rows[-1]} had no failures or "
                                     "no recovery saturations")
            k4 = k4_full_inputs(8, n_j, B, R, C, gen)
            for adc_name in ("24b", "7b"):
                adc = windows[adc_name]
                kw = dict(adc_lo=adc.lo, adc_hi=adc.hi, rows_per_xbar=rx)
                rows.append(compare("sliced_crossbar", sx.launch(*k4, **kw),
                                    sx.plain(*k4, **kw), site=site, B=B, R=R,
                                    C=C, n_j=n_j, adc=adc_name))
            for r in rows[-5:]:
                say("paper", **r)
            del x, planes, centers, args, k4
    torch.cuda.synchronize()


# ---------------------------------------------------------------- train
TRAIN_HOLD = ("qwen1.5-0.5b", "phi3.5-moe-42b")  # the card-vs-CPU configs
GRAD_RTOL = 1e-4  # tests/test_torch_train_grads.py's leaf tolerance
# SyntheticLM keeps a dense (v, v) float32 transition matrix and its
# cumsum on the host: 0.54 GB at 8,192 data tokens, 185 GB at qwen's
# 151,936, so the full-width runs learn a chain over the first 8,192 ids
TRAIN_DATA_VOCAB = 8192
TRAIN_RUNS = (("A", 64, 1, 20), ("B", 1024, 2, 5))  # seq, micro, steps
TRAIN_BATCH = 8
BF16_DENSE_FLOPS = 989e12  # H100 SXM, dense bf16 (data sheet)


def phase_train() -> None:
    import torch
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    train_card_vs_cpu()
    train_full_width()
    with train_launcher():  # a subprocess beside the restart checks
        train_restart()
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    if launches:
        raise AssertionError(f"kernels launched while training: {launches}")
    torch.cuda.synchronize()
    say("train", phase_s=round(time.perf_counter() - t0, 3),
        k1_k4_launches=0)


def _grad_err(got, want) -> tuple[float, float]:
    """(largest |got - want| over the leaves, largest ratio of it to the
    tests' bound GRAD_RTOL * (|want| + max|want|); <= 1 passes)."""
    from repro_torch.train import _tree
    worst_abs = worst = 0.0
    for g, w in zip(_tree.leaves(got), _tree.leaves(want), strict=True):
        d = (g.cpu().double() - w.double()).abs()
        bound = GRAD_RTOL * (w.double().abs() + w.double().abs().max())
        worst_abs = max(worst_abs, float(d.max()))
        worst = max(worst, float((d / bound.clamp_min(1e-30)).max()))
    return worst_abs, worst


def train_card_vs_cpu() -> None:
    """The train path's hold on the card (no kernel lies on it): one
    gradient step on the card and on the CPU from the same weights and
    batch, then one train step each."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import transformer as T
    from repro_torch.train import _tree
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_loop as tl
    ocfg = opt.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=200,
                           weight_decay=0.01)
    batch = SyntheticLM(64, 32, 8, seed=3).batch(0)
    for arch in TRAIN_HOLD:
        base = configs.get(arch).reduced(vocab_size=64, dtype="float32")
        host = T.init_params(base, seed=0, device="cpu")
        for micro in (1, 4):
            cfg = dataclasses.replace(base, micro_batches=micro)
            out = {}
            for dev in ("cuda", "cpu"):
                p = _tree.tree_map(lambda t: t.to(dev, copy=True), host)
                loss, grads = tl.make_grad_fn(cfg)(p, tl.to_device(batch, p))
                new_p, _, m = tl.make_train_step(cfg, ocfg)(
                    p, opt.init_state(ocfg, p), tl.to_device(batch, p))
                out[dev] = (float(loss), grads, float(m["loss"]),
                            _tree.tree_map(lambda t: t.cpu(), new_p))
            (lc, gc, sc, pc), (lh, gh, sh, ph) = out["cuda"], out["cpu"]
            loss_rel = abs(lc - lh) / abs(lh)
            step_rel = abs(sc - sh) / abs(sh)
            grad_abs, grad_ratio = _grad_err(gc, gh)
            dp = opt.global_norm(_tree.tree_map(lambda a, b: a - b, pc, ph))
            param_rel = float(dp) / float(opt.global_norm(ph))
            say("train", hold=arch, micro_batches=micro, loss_cuda=lc,
                loss_cpu=lh, loss_rel=f"{loss_rel:.3e}",
                grad_max_abs=f"{grad_abs:.3e}",
                grad_err_over_tol=f"{grad_ratio:.3f}",
                step_loss_rel=f"{step_rel:.3e}",
                params_rel=f"{param_rel:.3e}")
            if not (loss_rel <= 1e-5 and step_rel <= 1e-5
                    and grad_ratio <= 1.0 and param_rel < 1e-3):
                raise AssertionError(f"{arch} x{micro}: card and CPU differ")


def train_full_width() -> None:
    """qwen1.5-0.5b at its published size: run A (20 steps, the loss must
    fall by 0.3) and run B (1,024 tokens a row, 2 micro-batches)."""
    import dataclasses
    import statistics
    import torch
    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.train import fault_tolerance as ft
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_loop as tl
    base = configs.get(ARCH)
    for run, seq, micro, steps in TRAIN_RUNS:
        cfg = dataclasses.replace(base, micro_batches=micro)
        ocfg = opt.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=steps,
                               state_dtype=cfg.opt_state_dtype)
        data = SyntheticLM(vocab_size=TRAIN_DATA_VOCAB, seq_len=seq,
                           batch_size=TRAIN_BATCH, seed=0)
        losses, dts = [], []
        mon = ft.StragglerMonitor()

        def record(state, metrics, dt):
            losses.append(float(metrics["loss"]))
            dts.append(dt)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = tl.train(cfg, ocfg, data.iterator(0), num_steps=steps,
                         hooks=[mon.hook(), record], log_every=0)
        wall = time.perf_counter() - t0
        n = n_params_of(state.params)
        n_embed = state.params["embed"]["embed"].numel()
        tokens = TRAIN_BATCH * seq
        step_s = statistics.median(dts)
        tflops = 6 * (n - n_embed) * tokens / step_s / 1e12
        say("train", run=run, arch=ARCH, params=n, dtype=cfg.dtype,
            remat=cfg.remat, micro_batches=micro, batch=TRAIN_BATCH, seq=seq,
            data_vocab=TRAIN_DATA_VOCAB, model_vocab=cfg.vocab_size,
            steps=steps, wall_s=round(wall, 3),
            step_ms_median=round(step_s * 1e3, 3),
            step_ms_first=round(dts[0] * 1e3, 3),
            step_ms_min=round(min(dts) * 1e3, 3),
            tokens_per_s=round(tokens / step_s, 1),
            peak_gib=peak_gb(), resident_before_gib=round(resident / 2**30, 3),
            loss_first=round(losses[0], 4), loss_last=round(losses[-1], 4),
            model_tflops=round(tflops, 2),
            bf16_peak_tflops=BF16_DENSE_FLOPS / 1e12,
            stragglers=len(mon.events))
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"run {run}: a loss is not finite: {losses}")
        if run == "A" and not losses[-1] <= losses[0] - 0.3:
            raise AssertionError(f"run A: loss {losses[0]} -> {losses[-1]}"
                                 ", not 0.3 lower")
        say("train", run=run, **train_step_breakdown(
            cfg, ocfg, state, tl.to_device(data.batch(steps), state.params),
            step_s))
        del state
        torch.cuda.empty_cache()


def train_step_breakdown(cfg, ocfg, state, batch, step_s: float) -> dict:
    """One more step of a run, split at syncs into the gradients (forward,
    recompute, backward) and AdamW, then one whole step under
    ``torch.profiler``: its kernels' device time, against the run's
    median step for the card's busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_loop as tl
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, grads = tl.make_grad_fn(cfg)(state.params, batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    opt.apply_updates(ocfg, state.params, grads, state.opt_state)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del grads
    step = tl.make_train_step(cfg, ocfg)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(state.params, state.opt_state, batch)
        torch.cuda.synchronize()
    kernels = kernel_times(prof)
    dev_ms = sum(r[2] for r in kernels) / 1e3
    return dict(grad_ms=round((t1 - t0) * 1e3, 3),
                adamw_ms=round((t2 - t1) * 1e3, 3),
                kernels_device_ms=round(dev_ms, 3),
                cuda_kernels=sum(r[1] for r in kernels),
                busy_share=round(dev_ms / (step_s * 1e3), 4),
                top_kernels=top_kernels(kernels, 5))


def train_restart() -> None:
    """``resilient_train`` through an injected failure, then checkpoints
    across devices, bit for bit both ways."""
    import tempfile
    import torch
    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import transformer as T
    from repro_torch.train import _tree
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import fault_tolerance as ft
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_loop as tl
    cfg = configs.get(ARCH).reduced(vocab_size=64)
    ocfg = opt.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=200,
                           weight_decay=0.01)
    crashed = []

    def injector(step):
        if step == 12 and not crashed:
            crashed.append(step)
            raise RuntimeError("injected node failure")

    def fresh(dev, seed):
        p = T.init_params(cfg, seed=seed, device=dev)
        return p, opt.init_state(ocfg, p)

    def same(a, b) -> int:
        pairs = list(zip(_tree.leaves(a), _tree.leaves(b), strict=True))
        if not all(x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())
                   for x, y in pairs):
            raise AssertionError("a restored checkpoint differs")
        return sum(x.dtype == torch.bfloat16 for x, _ in pairs)

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        state = ft.resilient_train(
            cfg, ocfg, lambda s: SyntheticLM(64, 32, 8, seed=7).iterator(s),
            num_steps=20, ckpt_dir=f"{d}/run", ckpt_every=5,
            fail_injector=injector)
        restart_s = time.perf_counter() - t0
        last = ckpt.latest_step(f"{d}/run")
        if not (state.step == 20 and crashed and last == 20
                and _tree.leaves(state.params)[0].is_cuda):
            raise AssertionError(f"restart: step {state.step}, latest {last}")
        card = (state.params, state.opt_state)
        ckpt.save(f"{d}/card", 20, card)
        on_cpu, _, _ = ckpt.restore(f"{d}/card", fresh("cpu", 5))
        n_bf16 = same(on_cpu, card)
        p, o = on_cpu  # one CPU step, so the way back carries new values
        tl.make_train_step(cfg, ocfg)(p, o, SyntheticLM(
            64, 32, 8, seed=7).batch(20))
        ckpt.save(f"{d}/cpu", 21, on_cpu)
        on_card, step, _ = ckpt.restore(f"{d}/cpu", fresh("cuda", 6))
        same(on_card, on_cpu)
        if not (step == 21 and _tree.leaves(on_card)[0].is_cuda):
            raise AssertionError("CPU -> card restore")
    say("train", restart="failure injected at step 12", reached=state.step,
        latest_step=last, restart_s=round(restart_s, 3),
        card_to_cpu="bit for bit", cpu_to_card="bit for bit",
        leaves=len(_tree.leaves(card)), bf16_leaves=n_bf16)


@contextlib.contextmanager
def train_launcher():
    """``python -m repro_torch.launch.train --reduced --resilient`` as a
    subprocess on the card, running while the context's body runs (its
    ``launch_s`` then includes their sharing of the card); checked when
    the body ends."""
    import tempfile
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with tempfile.TemporaryDirectory() as d:
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
               ARCH, "--reduced", "--steps", "20", "--ckpt-dir", d,
               "--ckpt-every", "5", "--resilient"]
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, cwd=ROOT,
                                env=env)
        try:
            yield
            stdout, stderr = proc.communicate(timeout=600)
        finally:
            proc.kill()
        launch_s = time.perf_counter() - t0
    if proc.returncode != 0 or "done at step 20" not in stdout:
        raise AssertionError(f"launcher rc {proc.returncode}: "
                             f"{stdout[-2000:]} {stderr[-2000:]}")
    say("train", launcher=" ".join(cmd[2:]), rc=proc.returncode,
        launch_s=round(launch_s, 3),
        last_line=stdout.strip().splitlines()[-1])


# ---------------------------------------------------------------- dist
DIST_STEPS = 3  # run A's shape: TRAIN_BATCH x 64 tokens, one micro-batch
DIST_SEQ = 64


def phase_dist() -> None:
    """The distribution layer on a one-rank NCCL group (the host has one
    card; NCCL takes one rank per card): meshes, full-width placements
    under each rule set, the train step under a mesh against the step
    without one, ``compressed_psum`` against ``compress_decompress``, and a
    checkpoint restored onto another mesh, all bit for bit; K1-K4 are not
    launched."""
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import ops
    torch.cuda.set_device(0)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(d, "store"), 1),
            rank=0, world_size=1)
        try:
            ops.reset_launch_counts()
            meshes = dist_meshes()
            dist_place(meshes)
            grads = dist_step(meshes)
            dist_compressed(meshes, grads)
            del grads
            dist_checkpoint(meshes, d)
            launches = {k: v for k, v in ops.launch_counts().items() if v}
            if launches:
                raise AssertionError(f"kernels launched in dist: {launches}")
        finally:
            dist.destroy_process_group()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    say("dist", phase_s=round(time.perf_counter() - t0, 3),
        k1_k4_launches=0)


def dist_meshes() -> dict:
    """A 1x1 ("data", "model") and a 1x1x1 ("pod", "data", "model") mesh
    on the card; the production meshes must refuse a group of one."""
    from repro_torch.dist import compat
    from repro_torch.launch import mesh as lm
    meshes = {"test": lm.make_test_mesh(1, 1),
              "pod": compat.make_mesh((1, 1, 1), ("pod", "data", "model"))}
    refused = []
    for multi_pod in (False, True):
        try:
            lm.make_production_mesh(multi_pod=multi_pod)
        except ValueError as e:
            refused.append(str(e))
    if len(refused) != 2:
        raise AssertionError("a production mesh was built on one rank")
    say("dist", meshes={k: (m.device_type, tuple(m.mesh_dim_names),
                            tuple(m.shape)) for k, m in meshes.items()},
        production_refused=json.dumps(refused))
    return meshes


def _same_placed(placed, source) -> int:
    """Leaves checked: every placed leaf's ``full_tensor()`` equals its
    source in dtype and bits (non-tensor leaves pass through as given)."""
    import torch
    from repro_torch.train import _tree
    n = 0
    for p, s in zip(_tree.leaves(placed), _tree.leaves(source), strict=True):
        if not isinstance(s, torch.Tensor):
            if p is not s:
                raise AssertionError("a non-tensor leaf was replaced")
            continue
        full = p.full_tensor()
        if not (full.dtype == s.dtype and torch.equal(full, s)):
            raise AssertionError("a placed leaf differs from its source")
        n += 1
    return n


def _timed_place(tree, specs, mesh, rules):
    import torch
    from repro_torch.dist import sharding as dsh
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with dsh.axis_rules(rules):
        placed = dsh.place(tree, specs, mesh)
    torch.cuda.synchronize()
    return placed, round((time.perf_counter() - t0) * 1e3, 3)


def dist_place(meshes: dict) -> None:
    """qwen1.5-0.5b at full width placed under DEFAULT_RULES and
    SERVE_RULES, its exact plans (24b ADC) by ``plan_specs``, and a paged
    decode state by ``cache_specs(paged=True)`` under
    MULTIPOD_SERVE_RULES; every leaf gathered back bit for bit."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.dist import sharding as dsh
    from repro_torch.launch.serve import calibration_tokens
    from repro_torch.models import pim_compile as pc
    from repro_torch.models import transformer as T
    cfg = configs.get(ARCH)
    params = T.init_params(cfg, seed=0, device="cuda")
    specs = T.param_specs(cfg)
    # the group's first collective (NCCL's communicator) and DTensor's
    # first use, apart from the placements' times
    one = {"w": params["final_norm"]["scale"]}
    _, ms = _timed_place(one, {"w": (None,)}, meshes["test"],
                         dsh.DEFAULT_RULES)
    say("dist", first_placement_ms=ms, leaves=1)
    for name in ("DEFAULT_RULES", "SERVE_RULES"):
        placed, ms = _timed_place(params, specs, meshes["test"],
                                  getattr(dsh, name))
        say("dist", place="params", rules=name, params=n_params_of(params),
            leaves=_same_placed(placed, params), place_ms=ms,
            equal="bit for bit")
        del placed
    exact = dataclasses.replace(cfg, pim_mode="exact")
    compiled = pc.compile_pim_params(params, exact, calibration_tokens(cfg, 16))
    if compiled.specs != pc.plan_specs(exact):
        raise AssertionError("CompiledPim.specs != plan_specs")
    placed, ms = _timed_place(compiled.plans, compiled.specs, meshes["test"],
                              dsh.DEFAULT_RULES)
    say("dist", place="exact plans", adc_bits=exact.pim_adc_bits,
        leaves=_same_placed(placed, compiled.plans), place_ms=ms,
        equal="bit for bit")
    del placed, compiled
    layout = T.PagedLayout(n_blocks=4 * N_SLOTS, block_size=BLOCK)
    state = T.init_decode_state(cfg, N_SLOTS, 4 * BLOCK, per_slot_pos=True,
                                paged=layout, device="cuda")
    placed, ms = _timed_place(state, T.cache_specs(cfg, paged=True),
                              meshes["pod"], dsh.MULTIPOD_SERVE_RULES)
    say("dist", place="paged decode state", rules="MULTIPOD_SERVE_RULES",
        blocks=layout.n_blocks, leaves=_same_placed(placed, state),
        place_ms=ms, equal="bit for bit")


def dist_step(meshes: dict):
    """DIST_STEPS train steps of qwen1.5-0.5b at published size under the
    one-rank mesh (DTensor leaves, gathered, reduced) and without a mesh,
    from one start and on one batch stream: losses and parameters must be
    equal bit for bit (each collective is an identity on one rank).
    Returns the gradients of one more batch, without a mesh."""
    import dataclasses
    import statistics
    import torch
    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.dist import sharding as dsh
    from repro_torch.models import transformer as T
    from repro_torch.train import _tree
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_loop as tl
    cfg = dataclasses.replace(configs.get(ARCH), micro_batches=1)
    ocfg = opt.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=DIST_STEPS,
                           state_dtype=cfg.opt_state_dtype)
    data = SyntheticLM(vocab_size=TRAIN_DATA_VOCAB, seq_len=DIST_SEQ,
                       batch_size=TRAIN_BATCH, seed=0)
    start = T.init_params(cfg, seed=0, device="cuda")
    batches = [tl.to_device(data.batch(i), start)
               for i in range(DIST_STEPS + 1)]
    mesh, specs = meshes["test"], T.param_specs(cfg)
    runs = {}
    for run in ("mesh", "plain"):
        params = _tree.tree_map(torch.clone, start)  # placing aliases
        state = opt.init_state(ocfg, params)
        step = tl.make_train_step(cfg, ocfg)
        losses, dts = [], []
        with dsh.axis_rules(dsh.DEFAULT_RULES):
            if run == "mesh":
                params = dsh.place(params, specs, mesh)
                state = dsh.place(state, opt.state_specs(specs), mesh)
            for b in batches[:DIST_STEPS]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if run == "mesh":
                    with dsh.use_mesh(mesh):
                        params, state, m = step(params, state, b)
                else:
                    params, state, m = step(params, state, b)
                losses.append(m["loss"].item())
                dts.append(time.perf_counter() - t0)
        if run == "mesh":
            params = _tree.tree_map(lambda t: t.full_tensor(), params)
        runs[run] = (losses, dts, params)
        del state
    (lm_, dm, pm), (lp, dp, pp) = runs["mesh"], runs["plain"]
    worst = max(float((a.float() - b.float()).abs().max())
                for a, b in zip(_tree.leaves(pm), _tree.leaves(pp)))
    same = lm_ == lp and all(
        a.dtype == b.dtype and torch.equal(a, b)
        for a, b in zip(_tree.leaves(pm), _tree.leaves(pp), strict=True))
    say("dist", step=f"{DIST_STEPS} x ({TRAIN_BATCH} x {DIST_SEQ})",
        leaves=len(_tree.leaves(pp)), losses_mesh=json.dumps(lm_),
        losses_plain=json.dumps(lp), params_max_abs_diff=worst,
        equal="bit for bit" if same else "NO",
        step_ms_median_mesh=round(statistics.median(dm) * 1e3, 3),
        step_ms_median_plain=round(statistics.median(dp) * 1e3, 3),
        step_ms_mesh=json.dumps([round(t * 1e3, 3) for t in dm]),
        step_ms_plain=json.dumps([round(t * 1e3, 3) for t in dp]))
    if not same:
        raise AssertionError(
            f"the one-rank mesh's step differs from the plain step: losses "
            f"{lm_} vs {lp}, largest parameter difference {worst}")
    del pm, start
    _, grads = tl.make_grad_fn(cfg)(pp, batches[DIST_STEPS])
    return grads


def dist_compressed(meshes: dict, grads) -> None:
    """``compressed_psum`` over "data" of the one-rank mesh on a
    full-width gradient tree with an error carry: equal to
    ``compress_decompress`` leaf by leaf, and on three leaves to the same
    function on the CPU, bit for bit; timed beside its byte bound."""
    import torch
    from repro_torch.train import _tree
    from repro_torch.train import compression as comp
    err = _tree.tree_map(lambda g: g * 0.01, grads)

    def fn():
        return comp.compressed_psum(grads, meshes["test"], "data", err)
    mean, new_err = fn()
    paths, gs = _tree.flatten(grads)
    for g, e, m, ne in zip(gs, _tree.leaves(err), _tree.leaves(mean),
                           _tree.leaves(new_err), strict=True):
        want, want_err = comp.compress_decompress(g, e)
        if not (torch.equal(m, want) and torch.equal(ne, want_err)):
            raise AssertionError("compressed_psum != compress_decompress")
    by_size = sorted(range(len(gs)), key=lambda i: gs[i].numel())
    cpu_checked = []
    for i in (by_size[0], by_size[len(gs) // 2], by_size[-1]):
        want, want_err = comp.compress_decompress(gs[i].cpu(),
                                                  _tree.leaves(err)[i].cpu())
        if not (torch.equal(_tree.leaves(mean)[i].cpu(), want)
                and torch.equal(_tree.leaves(new_err)[i].cpu(), want_err)):
            raise AssertionError(f"{paths[i]}: card != CPU")
        cpu_checked.append(paths[i])
    del mean, new_err
    dts = []
    for _ in range(3):  # host clock to a sync: ~6,000 launches a call
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        dts.append((time.perf_counter() - t0) * 1e3)
    n = sum(g.numel() for g in gs)
    nbytes = 4 * n * gs[0].element_size()  # read g, e; write mean, error
    say("dist", compressed_psum="data", leaves=len(gs), elements=n,
        dtype=str(gs[0].dtype), equal="bit for bit",
        cpu_equal=json.dumps(cpu_checked), ms_median=round(sorted(dts)[1], 3),
        ms=json.dumps([round(t, 3) for t in dts]),
        bound_ms=round(nbytes / HBM_BYTES_PER_S * 1e3, 4), bound_by="bytes")


def dist_checkpoint(meshes: dict, d: str) -> None:
    """A checkpoint of qwen1.5-0.5b's placed parameters (full width) and of
    a reduced AdamW state, saved from the 1x1 mesh under DEFAULT_RULES and
    restored with ``shardings=`` onto the 1x1x1 mesh under MULTIPOD_RULES,
    bit for bit."""
    import torch
    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.dist import sharding as dsh
    from repro_torch.models import transformer as T
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_loop as tl
    reduced = configs.get(ARCH).reduced(vocab_size=64)
    ocfg = opt.AdamWConfig()
    small = T.init_params(reduced, seed=0, device="cuda")
    state = opt.init_state(ocfg, small)
    tl.make_train_step(reduced, ocfg)(small, state, tl.to_device(
        SyntheticLM(64, 32, 8, seed=7).batch(0), small))  # moments != 0
    cfg = configs.get(ARCH)
    for name, c, tree, specs in (
            ("params", cfg, T.init_params(cfg, seed=0, device="cuda"),
             T.param_specs(cfg)),
            ("reduced adamw state", reduced, state,
             opt.state_specs(T.param_specs(reduced)))):
        path = os.path.join(d, name.replace(" ", "_"))
        with dsh.axis_rules(dsh.DEFAULT_RULES):
            placed = dsh.place(tree, specs, meshes["test"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save(path, 1, placed)
        save_s = time.perf_counter() - t0
        with dsh.axis_rules(dsh.MULTIPOD_RULES):
            sh = dsh.named_shardings(specs, tree, meshes["pod"])
        t0 = time.perf_counter()
        back, step, _ = ckpt.restore(path, tree, shardings=sh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if step != 1 or any(t.device_mesh is not meshes["pod"]
                            for t in _leaves_placed(back)):
            raise AssertionError(f"{name}: restored off the pod mesh")
        say("dist", checkpoint=name, leaves=_same_placed(back, tree),
            n=n_params_of(tree), save_s=round(save_s, 3),
            restore_s=round(restore_s, 3), onto="1x1x1 pod mesh",
            rules="MULTIPOD_RULES", equal="bit for bit")
        del placed, back


def _leaves_placed(tree) -> list:
    from repro_torch.train import _tree
    return [t for t in _tree.leaves(tree) if hasattr(t, "device_mesh")]


# ------------------------------------------------------------- tp
TP_WORLD = 4          # processes on cuda:0, one gloo group
TP_MESH = (2, 2)      # ("data", "model")
TP_STEPS = 2          # of TRAIN_BATCH x TP_SEQ tokens (the train phase's A)
TP_SEQ = 64
TP_PROMPTS, TP_PROMPT_LEN = 4, 256
TP_TIMEOUT_S = 600
# the MoE model of the phase: phi3.5-moe-42b at its published widths, its
# 32 layers cut to TP_MOE_LAYERS (each rank places its blocks from a whole
# float32 copy, 5.8 GB a layer, and 4 ranks share the card); one float32
# train step of TP_MOE_ROWS x TP_SEQ tokens in one micro-batch (2 rows a
# rank of "data"): each of its published 2 would all-gather every expert
# block through host memory again, 8 GB a micro-batch and layer. One
# layer (2 until the recurrent models joined the phase): the script's
# time limit
TP_MOE_LAYERS = 1
TP_MOE_ROWS = 4
# qwen1.5-0.5b's 24 layers cut to 4: the phase's time goes to gloo's host
# staging, per layer (the dry-run phase runs qwen's rank programs whole)
TP_QWEN_LAYERS = 4
# the recurrent models at their published widths, cut to 2 layers each:
# rwkv6-3b (float32 train steps, a bf16 prefill, bf16 and float32 decode)
# and jamba-1.5-large-398b's pattern positions 0-1 (mamba + MoE FFN,
# mamba + dense FFN; 11.1 G parameters, 22 GB in bf16): a bf16 prefill
# and decode, on a (1, 4) mesh, where its FFN's 9.66 G-parameter expert
# blocks are not all-gathered over "data" through host memory (gloo) in
# the prefill; each rank makes its whole bf16 copy in turn (4 at once
# would not fit the card). Its train step stays off the card: float32
# parameters and gradients and bf16 moments of its smallest depth come to
# ~120 GB
TP_RECURRENT_LAYERS = 2
TP_JAMBA_MESH = (1, 4)
TP_ARCHS = (ARCH, MOE_ARCH, RWKV_ARCH, JAMBA_ARCH)
# float32 train, held to the train phase's card-vs-CPU tolerances: loss
# relative, grad norm relative (tests' NORM_RTOL), parameters' relative
# global norm
TP_LOSS_RTOL, TP_NORM_RTOL, TP_PARAM_RTOL = 1e-5, 1e-4, 1e-3
# bf16 prefill: the assembled logits' and caches' relative global-norm
# error against the one-process prefill (bf16's unit roundoff is 3.9e-3;
# the partitioned sums round their partial products once more)
TP_PREFILL_RTOL = 3e-2
# decode under SERVE_RULES: caches of TP_DECODE_LEN (the prompt fills the
# first "model" block, the decode writes the second), greedy steps; the
# bf16 logits' relative global-norm error against the one-process decode
# fed the same tokens (the prefill's bound), and float32's
TP_DECODE_LEN, TP_DECODE_STEPS = 512, 8
TP_DECODE_RTOL, TP_DECODE32_RTOL = 3e-2, 1e-4
# phi's bf16 runs: a rank's bf16 sums differ from the one process's by an
# ulp, which flips a token's experts where its router logits nearly tie;
# the one-process reference then takes the ranks' experts, and each
# flipped token's logit gap (how far below the one process's own choice
# the ranks' choice lies) must stay below this
TP_ROUTE_TIE = 5e-2


def phase_tp() -> None:
    """The partitioned train step, prefill and decode (``dist.parallel``)
    on ``TP_WORLD`` processes on ``cuda:0`` in one ``gloo`` group, mesh
    ``TP_MESH`` (module docstring), of qwen1.5-0.5b, of phi3.5-moe-42b
    cut to ``TP_MOE_LAYERS`` layers (expert parallel), of rwkv6-3b, and of
    jamba-1.5-large-398b (mesh ``TP_JAMBA_MESH``, no train step), both
    cut to ``TP_RECURRENT_LAYERS``: each rank's
    collectives, bytes, host-staged bytes and step ms printed; the
    gathered results held against the one-process runs on the card, made
    after the ranks have exited; K1-K4 are not launched."""
    import multiprocessing
    import tempfile
    import torch
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    torch.cuda.empty_cache()  # the ranks need the card's memory
    with tempfile.TemporaryDirectory() as d:
        mp = multiprocessing.get_context("spawn")
        procs = [mp.Process(target=tp_rank, args=(rank, d))
                 for rank in range(TP_WORLD)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + TP_TIMEOUT_S
        try:
            for p in procs:
                p.join(max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        res = []
        for rank, p in enumerate(procs):
            path = Path(d) / f"rank{rank}.pt"
            if not path.exists():
                crash = (Path(d) / f"rank{rank}.crash").read_text()[-3000:]
                raise AssertionError(f"tp rank {rank}: exit code "
                                     f"{p.exitcode}, no result\n{crash}")
            res.append(torch.load(path, weights_only=False))
    failed = [f"tp rank {rank} raised:\n{r['traceback'][-3000:]}"
              for rank, r in enumerate(res) if "traceback" in r]
    if failed:
        raise AssertionError("\n".join(failed))
    ranks_s = round(time.perf_counter() - t0, 3)
    for rank, r in enumerate(res):
        for line in r["lines"]:
            say("tp", rank=rank, **line)
        if r["launches"]:
            raise AssertionError(f"tp rank {rank} launched {r['launches']}")
    for arch in TP_ARCHS:
        ranks = [r[arch] for r in res]
        if arch != JAMBA_ARCH:
            tp_hold_train(arch, ranks)
        tp_hold_prefill(arch, ranks)
        tp_hold_decode(arch, ranks)
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    if launches:
        raise AssertionError(f"kernels launched in tp: {launches}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    say("tp", ok=True, world=TP_WORLD, mesh=json.dumps(TP_MESH),
        backend="gloo", archs=json.dumps(TP_ARCHS), ranks_s=ranks_s,
        phase_s=round(time.perf_counter() - t0, 3), k1_k4_launches=0)


def tp_rank(rank: int, d: str) -> None:
    """One rank of the tp phase, in its own process: open the group, run
    ``tp_run``, save ``rank<rank>.pt`` (a traceback if anything raised)."""
    import datetime
    import faulthandler
    import traceback
    import torch
    import torch.distributed as dist
    crash = open(os.path.join(d, f"rank{rank}.crash"), "w")
    faulthandler.enable(file=crash)  # a fatal signal's Python stack
    try:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(d, "store"), TP_WORLD),
            rank=rank, world_size=TP_WORLD,
            timeout=datetime.timedelta(seconds=TP_TIMEOUT_S // 2))
        try:
            res = tp_run(rank)
        finally:
            dist.destroy_process_group()
    except BaseException:
        res = {"traceback": traceback.format_exc()}
    torch.save(res, os.path.join(d, f"rank{rank}.pt"))


def tp_cfg(arch: str, dtype: str):
    """``arch`` in ``dtype`` (its KV cache too), qwen1.5-0.5b cut to
    ``TP_QWEN_LAYERS`` layers, phi3.5-moe-42b to ``TP_MOE_LAYERS`` and one
    micro-batch (``TP_MOE_ROWS``), rwkv6-3b and jamba-1.5-large-398b to
    ``TP_RECURRENT_LAYERS``."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.launch import dryrun
    layers = {MOE_ARCH: TP_MOE_LAYERS, RWKV_ARCH: TP_RECURRENT_LAYERS,
              JAMBA_ARCH: TP_RECURRENT_LAYERS}.get(arch, TP_QWEN_LAYERS)
    micro = {"micro_batches": 1} if arch in (MOE_ARCH, JAMBA_ARCH) else {}
    return dataclasses.replace(dryrun.cut_depth(configs.get(arch), layers),
                               dtype=dtype, kv_cache_dtype=dtype, **micro)


def tp_mesh_shape(arch: str) -> tuple:
    return TP_JAMBA_MESH if arch == JAMBA_ARCH else TP_MESH


def tp_decode_dtypes(arch: str) -> tuple:
    return ("bfloat16",) if arch == JAMBA_ARCH else ("bfloat16", "float32")


def tp_data(arch: str):
    """The tp phase's optimizer config, train batches (the train phase's
    run A source; phi's one step takes its first ``TP_MOE_ROWS`` rows;
    none for jamba) and prompts over ``arch``'s vocab, alike in every
    process."""
    import torch
    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.train import optimizer as opt
    cfg = configs.get(arch)
    steps = {MOE_ARCH: 1, JAMBA_ARCH: 0}.get(arch, TP_STEPS)
    ocfg = opt.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=steps,
                           state_dtype=cfg.opt_state_dtype)
    data = SyntheticLM(vocab_size=TRAIN_DATA_VOCAB, seq_len=TP_SEQ,
                       batch_size=TRAIN_BATCH, seed=0)
    batches = [data.batch(i) for i in range(steps)]
    if arch == MOE_ARCH:
        batches = [{k: v[:TP_MOE_ROWS] for k, v in b.items()}
                   for b in batches]
    prompts = torch.randint(0, cfg.vocab_size, (TP_PROMPTS, TP_PROMPT_LEN),
                            generator=torch.Generator().manual_seed(0))
    return ocfg, batches, prompts


def tp_run(rank: int) -> dict:
    """Each of ``TP_ARCHS`` in turn (``tp_model``), ``pim_mode`` off.
    Returns the lines to print, each arch's results and the rank's
    kernel launches."""
    import gc
    import torch
    from repro_torch.dist import compat
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    meshes = {shape: compat.make_mesh(shape, ("data", "model"),
                                      device_type="cuda")
              for shape in dict.fromkeys(map(tp_mesh_shape, TP_ARCHS))}
    out: dict = {"lines": []}
    for arch in TP_ARCHS:
        out[arch] = tp_model(rank, arch, meshes[tp_mesh_shape(arch)],
                             out["lines"])
        gc.collect()  # placed trees hold reference cycles (DTensor)
        torch.cuda.empty_cache()
    out["launches"] = {k: v for k, v in ops.launch_counts().items() if v}
    return out


def _staged(st) -> str:
    """The ops this group stages through host memory, as JSON."""
    from repro_torch.dist import parallel
    return json.dumps(sorted(op for op in st.by_op
                             if op not in parallel.GLOO_DEVICE_OPS))


def tp_jamba_turns(rank: int, mesh, prompts, lines: list) -> tuple:
    """jamba's placed trees, made one rank after another (a barrier
    between turns; 4 ranks' whole bf16 copies do not fit the card): the
    rank's whole copy from seed 0 placed under DEFAULT_RULES (the
    prefill's) and under SERVE_RULES with the one-process prefill of
    ``prompts`` into caches of ``TP_DECODE_LEN`` (the decode's), every
    block copied to host memory before the whole copy is freed and its
    memory released to the CUDA runtime (a block copied on the card would
    pin a segment of it). -> (the prefill's trees, the decode's), held
    on the host (``tp_on_card``); a line with the turn's seconds."""
    import gc
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.dist import sharding as dsh
    from repro_torch.models import transformer as T
    from repro_torch.train import _tree

    def to_host(x):
        if isinstance(x, DTensor):
            return (x.to_local().cpu(), x.device_mesh, x.placements,
                    x.shape, x.stride())
        return x.cpu() if isinstance(x, torch.Tensor) else x

    def on_host(trees):
        return [(_tree.tree_map(lambda _: None, t),
                 [to_host(x) for x in _tree.leaves(t)]) for t in trees]
    gc.collect()  # earlier programs' DTensors hold reference cycles
    torch.cuda.empty_cache()
    out = None
    for r in range(TP_WORLD):
        if r == rank:
            t0 = time.perf_counter()
            cfg = tp_cfg(JAMBA_ARCH, "bfloat16")
            params = T.init_params(cfg, seed=0, device="cuda")
            with dsh.axis_rules(dsh.DEFAULT_RULES):
                pre = on_host([dsh.place(params, T.param_specs(cfg), mesh)])
            with dsh.axis_rules(dsh.SERVE_RULES), torch.no_grad():
                first, state = T.prefill(params, cfg, prompts.to("cuda"),
                                         max_len=TP_DECODE_LEN)
                dec = on_host([dsh.place(params, T.param_specs(cfg), mesh),
                               dsh.place(state, T.cache_specs(cfg), mesh),
                               first])
            del params, first, state
            gc.collect()
            torch.cuda.empty_cache()
            out = pre, dec
            lines.append(dict(arch=JAMBA_ARCH, program="place_in_turns",
                              turn=r, turn_s=round(
                                  time.perf_counter() - t0, 3)))
        dist.barrier()
    return out


def tp_on_card(made: list) -> tuple:
    """``tp_jamba_turns``' trees from host memory, on the card."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.train import _tree

    def to_card(x):
        if isinstance(x, tuple):
            return DTensor.from_local(x[0].to("cuda"), x[1], x[2],
                                      run_check=False, shape=x[3],
                                      stride=x[4])
        return x.to("cuda") if isinstance(x, torch.Tensor) else x
    return tuple(_tree.unflatten(sk, [to_card(x) for x in xs])
                 for sk, xs in made)


def tp_train(rank: int, arch: str, mesh, ocfg, batches, lines: list,
             out: dict) -> None:
    """The partitioned float32 train steps of ``tp_model`` on ``batches``:
    losses and grad norms into ``out``, rank 0's gathered qwen and rwkv6
    parameters too, a line per step into ``lines``."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.dist import compat, parallel
    from repro_torch.dist import sharding as dsh
    from repro_torch.models import transformer as T
    from repro_torch.train import _tree
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_loop as tl
    cfg = tp_cfg(arch, "float32")
    specs = T.param_specs(cfg)
    p = dsh.place(T.init_params(cfg, seed=0, device="cuda"), specs, mesh)
    s = opt.init_state(ocfg, p)
    step = tl.make_train_step(cfg, ocfg)
    for i, b in enumerate(batches):
        b = tl.to_device(b, p)
        parallel.STATS.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, s, m = step(p, s, b)
        loss = m["loss"].item()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        st = parallel.STATS
        out["losses"].append(loss)
        out["norms"].append(float(m["grad_norm"]))
        lines.append(dict(
            arch=arch, program="train", dtype=cfg.dtype, step=i,
            rows=f"{b['inputs'].shape[0]}x{TP_SEQ}", loss=loss,
            collectives=st.calls, by_op=json.dumps(st.by_op),
            bytes=st.bytes, host_staged_bytes=st.staged_bytes,
            step_ms=round(dt * 1e3, 3), host_staged_ops=_staged(st),
            peak_gib=round(torch.cuda.max_memory_allocated() / 2 ** 30,
                           3)))
    if arch in (ARCH, RWKV_ARCH):
        # gathered on a host mesh of the same group: gloo's all-gather
        # takes no CUDA tensor (parallel.GLOO_DEVICE_OPS)
        host = compat.make_mesh(TP_MESH, ("data", "model"),
                                device_type="cpu")
        paths, flat = _tree.flatten(p)
        full = [DTensor.from_local(t.to_local().cpu(), host,
                                   t.placements, run_check=False,
                                   shape=t.shape, stride=t.stride()
                                   ).full_tensor()
                for t in flat]  # every rank takes part
        if rank == 0:
            out["params"] = dict(zip(paths, full))
        del full, flat
    del p, s
    torch.cuda.empty_cache()


def tp_model(rank: int, arch: str, mesh, lines: list) -> dict:
    """``arch`` at its published widths from seed 0 (``tp_cfg``): the
    partitioned train steps in float32 (``tp_data``; the moments made
    from the placed parameters, ``opt.init_state``; none for jamba), then
    a partitioned prefill of the rank's rows of the prompts in bf16, then
    the partitioned decode in bf16 and float32 (``tp_decode``; jamba's in
    bf16). Appends a line per program run to ``lines``; returns the
    losses and grad norms, rank 0's gathered qwen and rwkv6 parameters,
    and the rank's logits and cache blocks with its place in the mesh and
    its blocks of the recurrent channels and heads."""
    import gc
    import torch
    from repro_torch.dist import parallel
    from repro_torch.dist import sharding as dsh
    from repro_torch.models import transformer as T
    ocfg, batches, prompts = tp_data(arch)
    out: dict = {"losses": [], "norms": []}
    with dsh.axis_rules(dsh.DEFAULT_RULES), dsh.use_mesh(mesh):
        if batches:
            tp_train(rank, arch, mesh, ocfg, batches, lines, out)
        cfg16 = tp_cfg(arch, "bfloat16")
        dec = None
        if arch == JAMBA_ARCH:
            pre, dec = tp_jamba_turns(rank, mesh, prompts, lines)
            (placed,) = tp_on_card(pre)
            del pre
        else:
            placed = dsh.place(T.init_params(cfg16, seed=0, device="cuda"),
                               T.param_specs(cfg16), mesh)
        part = T.partition(placed, cfg16)
        rows = TP_PROMPTS // part.n_batch
        mine = prompts[part.batch_index * rows:
                       (part.batch_index + 1) * rows].to("cuda")
        parallel.STATS.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad(), recorded_routes() as routes:
            logits, state = T.prefill(placed, cfg16, mine)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        st = parallel.STATS
        lines.append(dict(
            arch=arch, program="prefill", dtype=cfg16.dtype,
            rows=f"{rows}x{TP_PROMPT_LEN}", collectives=st.calls,
            by_op=json.dumps(st.by_op), bytes=st.bytes,
            host_staged_bytes=st.staged_bytes, step_ms=round(dt * 1e3, 3),
            host_staged_ops=_staged(st), heads=json.dumps(part.heads),
            experts=json.dumps(part.experts),
            inner=json.dumps(part.inner),
            rwkv_heads=json.dumps(part.rwkv_heads),
            logits_shape=json.dumps(list(logits.shape)),
            cache_shapes=_cache_shapes(state["caches"][0])))
        out["prefill"] = dict(
            logits=logits.cpu(), batch_index=part.batch_index,
            model_rank=part.model.rank, routes=routes, inner=part.inner,
            rwkv_heads=part.rwkv_heads,
            caches=[{k: v.cpu() for k, v in c.items()}
                    for c in state["caches"]])
        del placed, state, logits, part
        gc.collect()  # DTensors hold reference cycles
        torch.cuda.empty_cache()
        for dtype in tp_decode_dtypes(arch):
            out[f"decode_{dtype}"] = tp_decode(
                tp_cfg(arch, dtype), mesh, prompts, lines,
                None if dec is None else tp_on_card(dec))
            torch.cuda.empty_cache()
    return out


def _cache_shapes(cache: dict) -> str:
    """A layer's cache leaves' local shapes, as JSON."""
    return json.dumps({k: list(getattr(v, "to_local", lambda: v)().shape)
                       for k, v in cache.items()})


def tp_decode(cfg, mesh, prompts, lines: list, made=None) -> dict:
    """The partitioned decode on this rank under SERVE_RULES: the
    one-process prefill of ``prompts`` into caches of ``TP_DECODE_LEN``
    placed by ``cache_specs``, the weights by ``param_specs`` (``made``:
    jamba's, from ``tp_jamba_turns``), then ``TP_DECODE_STEPS`` greedy
    steps; a line per step. Returns the tokens (whole) and each step's
    vocab block of the logits."""
    import torch
    from repro_torch.dist import parallel
    from repro_torch.dist import sharding as dsh
    from repro_torch.models import transformer as T
    with dsh.axis_rules(dsh.SERVE_RULES), torch.no_grad():
        if made is None:
            params = T.init_params(cfg, seed=0, device="cuda")
            first, state = T.prefill(params, cfg, prompts.to("cuda"),
                                     max_len=TP_DECODE_LEN)
            made = (dsh.place(params, T.param_specs(cfg), mesh),
                    dsh.place(state, T.cache_specs(cfg), mesh), first)
            del params
        placed, state, first = made
        del made
        torch.cuda.empty_cache()
        part = T.partition(placed, cfg, decode=True)
        tok = first.argmax(-1)
        tokens, logits = [tok.cpu()], []
        moe = [f"layers/{i}/ffn/w1" for i in range(cfg.n_layers)
               if f"layers/{i}/ffn/router" in part.leaf]
        with recorded_routes() as routes:
            for i in range(TP_DECODE_STEPS):
                parallel.STATS.reset()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lg, state = T.decode_step(placed, cfg, state, tok)
                tok = part.greedy(lg)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                st = parallel.STATS
                lines.append(dict(
                    arch=cfg.name, program="decode", dtype=cfg.dtype, step=i,
                    rows=f"{prompts.shape[0]}x1", pos=TP_PROMPT_LEN + i,
                    collectives=st.calls, by_op=json.dumps(st.by_op),
                    bytes=st.bytes, host_staged_bytes=st.staged_bytes,
                    step_ms_host_staged=round(dt * 1e3, 3),
                    host_staged_ops=_staged(st),
                    logits_shape=json.dumps(list(lg.shape)),
                    cache_shapes=_cache_shapes(state["caches"][0]),
                    **({"experts": json.dumps(part.experts(moe[0]))}
                       if moe else {})))
                tokens.append(tok.cpu())
                logits.append(lg.cpu())
        v0 = part.leaf["embed/head"].start
    return dict(tokens=torch.cat(tokens, dim=1), logits=logits,
                vocab_start=v0, routes=routes)


@contextlib.contextmanager
def recorded_routes():
    """The expert ids (B, n_groups, group), on the host, of each
    ``layers.moe_route`` call made in the body."""
    from repro_torch.models import layers as L
    orig, log = L.moe_route, []

    def rec(*args):
        rt = orig(*args)
        log.append(rt.expert.cpu())
        return rt
    L.moe_route = rec
    try:
        yield log
    finally:
        L.moe_route = orig


@contextlib.contextmanager
def forced_routes(routes: list):
    """``layers.moe_route`` made to choose, call by call, the experts of
    ``routes`` (each (B, n_groups, group), as ``recorded_routes`` gives
    them), gated by this process's own logits. Yields a dict: ``flips``,
    the tokens whose chosen experts (or their order) differ from this
    process's own top k, and ``gap``, the largest amount by which a
    flipped token's forced choice lies below its own choice's logit."""
    import torch
    from repro_torch.models import layers as L
    orig, it = L.moe_route, iter(routes)
    seen = {"flips": 0, "gap": 0.0}
    if not routes:  # no MoE layer, or a run left to route itself
        yield seen
        return

    def forced(params, cfg, x):
        B, S, _ = x.shape
        k = cfg.experts_per_token
        want = next(it).to(x.device).reshape(B, -1)[:, :S * k]
        idx = want.reshape(B, S, k)
        logits = L.moe_logits(params, x)
        own, _ = torch.topk(logits, k, dim=-1)
        vals = logits.gather(-1, idx)
        flipped = (idx != torch.topk(logits, k, dim=-1).indices).any(-1)
        seen["flips"] += int(flipped.sum())
        if flipped.any():
            seen["gap"] = max(seen["gap"], float(
                (own - vals).amax(-1)[flipped].max()))
        return L.route_choices(cfg, idx, vals, x.dtype)
    L.moe_route = forced
    try:
        yield seen
    finally:
        L.moe_route = orig


def tp_hold_train(arch: str, res: list) -> None:
    """The ranks' losses and grad norms agree; against the one-process
    float32 run on the card, the train phase's tolerances: qwen's steps
    (losses, grad norms, the gathered parameters), phi's one step's loss
    and grad norm (its gradient alone, ``make_grad_fn``: the whole model's
    float32 moments would not fit beside it)."""
    from repro_torch.models import transformer as T
    from repro_torch.train import _tree
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_loop as tl
    for r in res[1:]:
        if r["losses"] != res[0]["losses"]:
            raise AssertionError(f"tp: {arch}: the ranks' losses differ: "
                                 f"{[x['losses'] for x in res]}")
    cfg = tp_cfg(arch, "float32")
    ocfg, batches, _ = tp_data(arch)
    params = T.init_params(cfg, seed=0, device="cuda")
    losses, norms, param_rel = [], [], None
    if arch == MOE_ARCH:
        loss, grads = tl.make_grad_fn(cfg)(params, tl.to_device(batches[0],
                                                                params))
        losses.append(loss.item())
        norms.append(float(opt.global_norm(grads)))
        del grads
    else:
        state = opt.init_state(ocfg, params)
        step = tl.make_train_step(cfg, ocfg)
        for b in batches:
            params, state, m = step(params, state, tl.to_device(b, params))
            losses.append(m["loss"].item())
            norms.append(float(m["grad_norm"]))
        del state
        got = res[0]["params"]
        paths, flat = _tree.flatten(params)
        num = sum(float(((got[k].cuda().double() - t.double()) ** 2).sum())
                  for k, t in zip(paths, flat))
        den = sum(float((t.double() ** 2).sum()) for t in flat)
        param_rel = (num / den) ** 0.5
        del flat
    loss_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(res[0]["losses"], losses))
    norm_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(res[0]["norms"], norms))
    say("tp", held="train", arch=arch, dtype=cfg.dtype,
        losses=json.dumps(res[0]["losses"]),
        losses_one_process=json.dumps(losses),
        grad_norms=json.dumps(res[0]["norms"]),
        grad_norms_one_process=json.dumps(norms),
        loss_rel=f"{loss_rel:.3e}", grad_norm_rel=f"{norm_rel:.3e}",
        params_rel="not held" if param_rel is None else f"{param_rel:.3e}")
    if not (loss_rel <= TP_LOSS_RTOL and norm_rel <= TP_NORM_RTOL
            and (param_rel is None or param_rel < TP_PARAM_RTOL)):
        raise AssertionError(f"tp: {arch}: the partitioned step differs "
                             "from the one-process step")
    del params


def tp_hold_prefill(arch: str, res: list) -> None:
    """The ranks' logits blocks (rows x vocab shards) and cache blocks
    (rows x sequence blocks) assembled against the one-process bf16
    prefill on the card, within ``TP_PREFILL_RTOL``; a MoE model's
    one-process prefill takes the ranks' experts (``forced_routes``)."""
    import torch
    from repro_torch.models import transformer as T
    cfg = tp_cfg(arch, "bfloat16")
    _, _, prompts = tp_data(arch)
    params = T.init_params(cfg, seed=0, device="cuda")
    first = sorted((r["prefill"] for r in res if
                    r["prefill"]["model_rank"] == 0),
                   key=lambda pf: pf["batch_index"])
    routes = [torch.cat(layer) for layer in zip(*(pf["routes"]
                                                  for pf in first))]
    with torch.no_grad(), forced_routes(routes) as seen:
        want, state = T.prefill(params, cfg, prompts.to("cuda"))
    del params
    logits = torch.full(want.shape, float("nan"), dtype=want.dtype)
    caches = [{k: torch.full(v.shape, float("nan"), dtype=v.dtype)
               for k, v in c.items()} for c in state["caches"]]
    for r in res:
        pf = r["prefill"]
        rows, nv = pf["logits"].shape[0], pf["logits"].shape[-1]
        b0, v0 = pf["batch_index"] * rows, pf["model_rank"] * nv
        logits[b0:b0 + rows, :, v0:v0 + nv] = pf["logits"]
        for got, c in zip(caches, pf["caches"]):
            for k, blk in c.items():
                got[k][tp_block(pf, "k" in c, k, blk, got[k].shape,
                                b0)] = blk

    def rel(a, b):
        a, b = a.double(), b.cpu().double()
        return float((a - b).norm() / b.norm()), float((a - b).abs().max())
    lrel, labs = rel(logits, want)
    crel = max(rel(got[k], c[k])[0] for got, c in zip(caches,
                                                      state["caches"])
               for k in c)
    say("tp", held="prefill", arch=arch, dtype=cfg.dtype,
        prompts=f"{TP_PROMPTS}x{TP_PROMPT_LEN}", logits_rel=f"{lrel:.3e}",
        logits_max_abs=f"{labs:.3e}", caches_rel=f"{crel:.3e}",
        tol=TP_PREFILL_RTOL, moe_routes=len(routes),
        route_flips=seen["flips"], flip_gap=f"{seen['gap']:.3e}")
    if not (lrel <= TP_PREFILL_RTOL and crel <= TP_PREFILL_RTOL
            and seen["gap"] <= TP_ROUTE_TIE):
        raise AssertionError(f"tp: {arch}: the partitioned prefill differs "
                             "from the one-process prefill")


def tp_block(pf: dict, attn: bool, name: str, blk, shape, b0: int):
    """Where a rank's prefill cache block lies in the whole cache: an
    attention cache's rows by its sequence block; a carry's rows by its
    d_inner block (mamba ``h`` dim 1, ``conv`` dim 2) or heads (rwkv
    ``h`` dim 1) where ``cache_specs`` splits them, else whole."""
    idx = [slice(b0, b0 + blk.shape[0])] + [slice(None)] * (blk.ndim - 1)
    if attn:
        s0 = pf["model_rank"] * blk.shape[1]
        idx[1] = slice(s0, s0 + blk.shape[1])
    elif name in ("h", "conv"):
        d = 2 if name == "conv" else 1
        if blk.shape[d] != shape[d]:
            c0 = pf["inner" if blk.ndim == 3 else "rwkv_heads"][0]
            idx[d] = slice(c0, c0 + blk.shape[d])
    return tuple(idx)


def tp_hold_decode(arch: str, res: list) -> None:
    """The partitioned decode against the one-process decode on the card,
    from the same prefill: every rank's tokens alike; per dtype, the
    ranks' logits assembled by vocab against the one-process decode fed
    the partitioned run's tokens and, of a MoE model, experts
    (``forced_routes``; relative global norm), and the greedy tokens
    equal to the one-process greedy run's (but qwen's, in float32 alone:
    a bf16 near-tie among the top logits may break them, and the forced
    logits hold the bf16 run; jamba decodes in bf16 alone)."""
    import torch
    from repro_torch.models import transformer as T
    _, _, prompts = tp_data(arch)
    tols = {"bfloat16": TP_DECODE_RTOL, "float32": TP_DECODE32_RTOL}
    for dtype in tp_decode_dtypes(arch):
        key, tol = f"decode_{dtype}", tols[dtype]
        toks = res[0][key]["tokens"]
        for r in res[1:]:
            if not torch.equal(r[key]["tokens"], toks):
                raise AssertionError(f"tp: {arch}: the ranks' {dtype} "
                                     "decode tokens differ")
        cfg = tp_cfg(arch, dtype)
        params = T.init_params(cfg, seed=0, device="cuda")
        runs = {}
        with torch.no_grad():
            for run in ("forced", "greedy"):
                first, state = T.prefill(params, cfg, prompts.to("cuda"),
                                         max_len=TP_DECODE_LEN)
                tok, got, lgs = first.argmax(-1), [first.argmax(-1)], []
                # the forced run takes the ranks' tokens and experts
                with forced_routes(res[0][key]["routes"]
                                   if run == "forced" else []) as seen:
                    for i in range(TP_DECODE_STEPS):
                        if run == "forced":
                            tok = toks[:, i:i + 1].to("cuda")
                        lg, state = T.decode_step(params, cfg, state, tok)
                        tok = lg.argmax(-1)
                        got.append(tok)
                        lgs.append(lg.cpu())
                runs[run] = torch.cat(got, dim=1).cpu(), lgs, seen
                del state
        del params
        want_logits = runs["forced"][1]
        rel = 0.0
        for i, want in enumerate(want_logits):
            full = torch.full(want.shape, float("nan"), dtype=want.dtype)
            for r in res:
                blk, v0 = r[key]["logits"][i], r[key]["vocab_start"]
                full[..., v0:v0 + blk.shape[-1]] = blk
            a, b = full.double(), want.double()
            rel = max(rel, float((a - b).norm() / b.norm()))
        greedy, seen = runs["greedy"][0], runs["forced"][2]
        same = int((greedy == toks).sum())
        say("tp", held="decode", arch=arch, dtype=dtype,
            steps=TP_DECODE_STEPS, cache_len=TP_DECODE_LEN,
            logits_rel=f"{rel:.3e}", tol=tol,
            tokens=json.dumps(toks.tolist()),
            tokens_one_process=json.dumps(greedy.tolist()),
            tokens_equal=f"{same}/{greedy.numel()}",
            moe_routes=len(res[0][key]["routes"]),
            route_flips=seen["flips"], flip_gap=f"{seen['gap']:.3e}")
        if not (rel <= tol and seen["gap"] <= TP_ROUTE_TIE):
            raise AssertionError(f"tp: {arch}: the partitioned {dtype} "
                                 "decode's logits differ from the "
                                 "one-process decode's")
        if (dtype == "float32" or arch == ARCH) and \
                not torch.equal(greedy, toks):
            raise AssertionError(f"tp: {arch}: the partitioned {dtype} "
                                 "decode's greedy tokens differ from the "
                                 "one-process decode's")


# ------------------------------------------------------------- disagg
DISAGG_WORLD = 2  # a prefill rank and a decode rank, both on cuda:0
DISAGG_TIMEOUT_S = 600
# the disaggregated runs: (name, pim_mode, pool blocks or None = no
# pressure, the kernel of the mode)
DISAGG_RUNS = (("disagg-exact", "exact", 5, "fused_spec_crossbar"),
               ("disagg-fast", "fast", None, "centered_int8_matmul"))


@contextlib.contextmanager
def dryrun_sweep():
    """The dry run's cells of ``DRYRUN_ARCHS`` on both meshes, then the
    decode_32k cells of ``DRYRUN_DECODE_ARCHS``, as two ``python -m
    repro_torch.launch.dryrun`` runs one after the other in a shell of its
    own session writing into a temporary directory, at the lowest CPU
    priority (the card's host work comes first); killed with its workers
    if it still runs when the context exits. -> (process, reports
    directories, log path)."""
    import shlex
    import signal
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        outs = [os.path.join(d, "reports"), os.path.join(d, "decode")]
        log_path = os.path.join(d, "sweep.log")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (str(ROOT / "src"), os.environ.get("PYTHONPATH"))
            if p))
        cli = [sys.executable, "-m", "repro_torch.launch.dryrun", "--jobs",
               str(DRYRUN_JOBS)]
        script = " && ".join(shlex.join(c) for c in (
            cli + ["--arch", ",".join(DRYRUN_ARCHS), "--out", outs[0]],
            cli + ["--arch", ",".join(DRYRUN_DECODE_ARCHS), "--shape",
                   "decode_32k", "--out", outs[1]]))
        with open(log_path, "w") as log:
            proc = subprocess.Popen(
                ["sh", "-c", script],
                cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT,
                start_new_session=True, preexec_fn=lambda: os.nice(19))
            try:
                yield proc, outs, log_path
            finally:
                if proc.poll() is None:
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.wait()


def phase_dryrun(ctx: dict) -> None:
    """qwen1.5-0.5b's decode_32k, prefill_32k and train_4k per-rank
    programs and rwkv6-3b's decode_32k run for real on the card, and the
    decode_32k programs of ``DRYRUN_CUT`` beside in-process dry runs of
    the same cut configs; then the sweep, which ``main`` started with the
    script, is waited for, and each program is held against its cell's
    report (module docstring); K1-K4 are not launched."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    total = torch.cuda.get_device_properties(0).total_memory
    proc, outs, log_path = ctx.pop("sweep")
    running = proc.poll() is None
    measured = {p: dryrun_on_card(*p) for p in DRYRUN_PROGRAMS}
    cuts = [(arch, n, dryrun_on_card(arch, "decode_32k", layers=n),
             dryrun.dryrun_cell(arch, "decode_32k", multi_pod=False,
                                verbose=False, device="cuda", n_layers=n))
            for arch, n in DRYRUN_CUT]
    waited = time.perf_counter()
    rc = proc.wait(timeout=DRYRUN_SWEEP_TIMEOUT)
    wait_s = round(time.perf_counter() - waited, 1)
    with open(log_path) as f:
        tail = f.read()[-4000:]
    if rc != 0:
        raise AssertionError(f"the dry-run sweep exited {rc}:\n{tail}")
    reports = []
    for out in outs:
        with open(os.path.join(out, "summary.json")) as f:
            reports += json.load(f)
    dryrun_sweep_lines(reports)
    for arch, name in DRYRUN_PROGRAMS:
        (r,) = [r for r in reports if r["arch"] == arch
                and r["shape"] == name and not r["multi_pod"]]
        dryrun_held(arch, name, r, measured[arch, name], smi, total)
    for arch, n, run, report in cuts:
        dryrun_held(arch, f"decode_32k/{n}-layers", report, run, smi, total)
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    if launches:
        raise AssertionError(f"kernels launched in dryrun: {launches}")
    say("dryrun", phase_s=round(time.perf_counter() - t0, 3),
        sweep_running_at_phase_start=running, sweep_wait_s=wait_s,
        jobs=DRYRUN_JOBS, k1_k4_launches=0)


def dryrun_on_card(arch: str, shape_name: str,
                   layers: int | None = None) -> dict:
    """``arch``'s per-rank program of ``shape_name`` on the 16x16
    mesh (its depth cut to ``layers`` where given), run for real on the
    card: the dry run's own ``rank_program``
    (weights from seed 0, zeroed inputs and caches), one warm-up under
    ``FlopCounterMode`` with the peak of allocated bytes above what the
    process held before, then ``DRYRUN_RUNS`` runs timed by CUDA events.
    Every program is partitioned and runs as rank 0 of a fake 256-rank
    group (its collectives move nothing; the group is destroyed
    afterwards), the train step with grad enabled."""
    import gc
    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch import configs
    from repro_torch.dist import sharding as dsh
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    cfg = configs.get(arch)
    if layers is not None:
        cfg = dryrun.cut_depth(cfg, layers)
    shape = {s.name: s for s in configs.ALL_SHAPES}[shape_name]
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    try:
        mesh = make_production_mesh(device_type="cuda")
        within = dsh.use_mesh(mesh)
        with dsh.axis_rules(dryrun.cell_rules(shape, multi_pod=False)):
            step, args = dryrun.rank_program(cfg, shape, mesh, "cuda")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with within, torch.set_grad_enabled(shape.kind == "train"):
                with FlopCounterMode(display=False) as fc:
                    step(*args)
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() - base
                ms = []
                for _ in range(DRYRUN_RUNS):
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    out = step(*args)
                    b.record()
                    torch.cuda.synchronize()
                    ms.append(a.elapsed_time(b))
                    del out
        first = args[-1][next(iter(args[-1]))]
        rows = getattr(first, "_local_tensor", first).shape[0]
        del step, args, first
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    return {"flops": fc.get_total_flops(), "peak": peak, "ms": ms,
            "rows": rows}


def dryrun_sweep_lines(reports: list) -> None:
    """One line per swept cell; every cell must be ``ok``; the fits count
    and the bounds' histogram."""
    from repro_torch import configs
    want = 2 * sum(len(configs.runnable_shapes(configs.get(a)))
                   for a in DRYRUN_ARCHS) + 2 * len(DRYRUN_DECODE_ARCHS)
    if len(reports) != want:
        raise AssertionError(f"the sweep gave {len(reports)} cells, not "
                             f"{want}")
    bad = [(r["arch"], r["shape"], r["multi_pod"], r.get("error"))
           for r in reports if r["status"] != "ok"]
    if bad:
        raise AssertionError(f"dry-run cells not ok: {bad}")
    bounds: dict = {}
    for r in reports:
        say("dryrun", cell=f"{r['arch']}/{r['shape']}/"
            f"{'2x16x16' if r['multi_pod'] else '16x16'}",
            gib=r["per_device_gib"], fits=r["fits_hbm"],
            compute_s=f"{r['compute_s']:.4e}",
            memory_s=f"{r['memory_s']:.4e}",
            collective_s=f"{r['collective_s']:.4e}",
            bound=r["bottleneck"],
            useful=f"{r['useful_flops_ratio']:.4f}",
            fake_s=r["compile_seconds"])
        bounds[r["bottleneck"]] = bounds.get(r["bottleneck"], 0) + 1
    say("dryrun", cells=len(reports),
        fits=sum(r["fits_hbm"] for r in reports),
        bounds=json.dumps(bounds, sort_keys=True))


def dryrun_held(arch: str, name: str, report: dict, m: dict, smi: str,
                total: int) -> None:
    """One per-rank program's card run against its cell's report: flops
    equal, peak allocated bytes within ``DRYRUN_MEM_TOL``."""
    from repro_torch.launch import dryrun
    if dryrun.HBM_PER_CHIP > total:
        raise AssertionError(f"HBM_PER_CHIP {dryrun.HBM_PER_CHIP} exceeds "
                             f"the card's total_memory {total}")
    if m["flops"] != report["hlo_flops_per_device"]:
        raise AssertionError(
            f"{arch}/{name}: FlopCounterMode counted {m['flops']} on the "
            f"card, the "
            f"dry run {report['hlo_flops_per_device']}")
    ratio = m["peak"] / report["per_device_bytes"]
    med = statistics.median(m["ms"])
    bound_s = max(report["compute_s"], report["memory_s"])
    say("dryrun", program=f"{arch}/{name}/16x16", rows=m["rows"],
        flops=m["flops"], dryrun_flops=report["hlo_flops_per_device"],
        max_memory_allocated=m["peak"],
        per_device_bytes=report["per_device_bytes"],
        ratio=f"{ratio:.4f}", median_ms=f"{med:.3f}",
        runs=json.dumps([round(x, 3) for x in m["ms"]]),
        compute_s=f"{report['compute_s']:.4e}",
        memory_s=f"{report['memory_s']:.4e}",
        roofline_reached=f"{bound_s / (med / 1e3):.4f}",
        total_memory=total, card=json.dumps(smi))
    if abs(ratio - 1) > DRYRUN_MEM_TOL:
        raise AssertionError(
            f"{arch}/{name}: max_memory_allocated {m['peak']} is not within "
            f"{DRYRUN_MEM_TOL:.0%} of the dry run's per_device_bytes "
            f"{report['per_device_bytes']} (ratio {ratio:.4f})")


def phase_disagg(ctx: dict, rows: list) -> None:
    """The paged engine's disaggregated prefill/decode mode on two ranks
    of one ``gloo`` group (spawned processes on ``cuda:0``; NCCL takes one
    rank per card), qwen1.5-0.5b at its published size; each rank's
    results come back as JSON and are checked and printed here."""
    import multiprocessing
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        mp = multiprocessing.get_context("spawn")
        procs = [mp.Process(target=disagg_rank, args=(rank, d))
                 for rank in range(DISAGG_WORLD)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + DISAGG_TIMEOUT_S
        try:
            for p in procs:
                p.join(max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        res = []
        for rank, p in enumerate(procs):
            path = Path(d) / f"rank{rank}.json"
            if not path.exists():
                raise AssertionError(f"disagg rank {rank}: exit code "
                                     f"{p.exitcode}, no result")
            res.append(json.loads(path.read_text()))
    for rank, r in enumerate(res):
        if "traceback" in r:
            raise AssertionError(f"disagg rank {rank} raised:\n"
                                 f"{r['traceback']}")
    for rank, r in enumerate(res):
        for line in r["lines"]:
            say("disagg", rank=rank, **line)
        rows += r["rows"]
    if res[0]["checksums"] != res[1]["checksums"]:
        raise AssertionError("the ranks' params or plans differ")
    launches = {}
    for name, _, _, kernel in DISAGG_RUNS:
        toks = [r["tokens"][name] for r in res]
        ref = res[1]["reference"][name]
        if not (toks[0] == toks[1] == ref["paged"] == ref["continuous"]):
            raise AssertionError(f"{name}: disaggregated tokens {toks}, "
                                 f"one-process paged {ref['paged']}, "
                                 f"continuous {ref['continuous']}")
        serve = ctx.get("qwen", {}).get("tokens", {}).get(
            name.split("-")[1])
        if serve is not None and serve != toks[0]:
            raise AssertionError(f"{name}: tokens differ from the serve "
                                 "phase's continuous engine's")
        launches[kernel] = launches.get(kernel, 0) + sum(
            r["launches"][name][kernel] for r in res)
    ctx["disagg_launches"] = launches
    say("disagg", ok=True, world=DISAGG_WORLD, backend="gloo",
        phase_s=round(time.perf_counter() - t0, 3),
        launches=json.dumps(launches),
        checksummed_leaves=len(res[0]["checksums"]),
        tokens_equal="disaggregated == one-process paged == continuous "
        "(run on the decode rank)" + (" == serve phase" if "qwen" in ctx
                                      else ""))


def disagg_rank(rank: int, d: str) -> None:
    """One rank of the disagg phase, in its own process: open the group,
    serve, write ``rank<rank>.json`` (a traceback if anything raised)."""
    import datetime
    import traceback
    import torch
    import torch.distributed as dist
    try:
        torch.cuda.set_device(0)
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(d, "store"),
                                         DISAGG_WORLD),
            rank=rank, world_size=DISAGG_WORLD,
            timeout=datetime.timedelta(seconds=DISAGG_TIMEOUT_S // 2))
        try:
            res = disagg_serve(rank)
        finally:
            dist.destroy_process_group()
    except BaseException:
        res = {"traceback": traceback.format_exc()}
    Path(d, f"rank{rank}.json").write_text(json.dumps(res))


def leaf_checksums(tree) -> list:
    """Two wrapping int64 sums per tensor leaf over its bytes read as
    int64 words (zero-padded), one of them position-weighted: equal trees
    give equal lists."""
    import torch
    from repro_torch.train import _tree
    out = []
    for path, t in zip(*_tree.flatten(tree)):
        if not isinstance(t, torch.Tensor):
            continue
        b = t.detach().contiguous().reshape(-1).view(torch.uint8)
        if b.numel() % 8:
            b = torch.cat([b, b.new_zeros(-b.numel() % 8)])
        w = b.view(torch.int64)
        pos = torch.arange(w.numel(), device=w.device) % 65521 + 1
        out.append([path, int(w.sum()), int((w * pos).sum())])
    return out


def record_first(kernel: str, n: int) -> tuple:
    """Wrap ``kernel``'s launcher so that its first ``n`` calls keep their
    operands and results; returns (the record, the undo)."""
    from repro_torch.kernels import fused_spec_crossbar as fs
    from repro_torch.kernels import int8_matmul as im
    mod = {"fused_spec_crossbar": fs, "centered_int8_matmul": im}[kernel]
    orig, log = mod.launch, []

    def launch(*args, **kw):
        out = orig(*args, **kw)
        if len(log) < n:
            log.append((args, kw, out))
        return out
    mod.launch = launch
    return log, lambda: setattr(mod, "launch", orig)


def disagg_serve(rank: int) -> dict:
    """A rank's part: qwen1.5-0.5b at published size (bf16, the serve
    phase's seed) with its pinned exact and fast plans at the 24b ADC,
    checksummed; the serve phase's 4 requests through the disaggregated
    ``PagedServeEngine`` in each of ``DISAGG_RUNS`` (launches counted, the
    first engine call's kernel calls recorded and held bit for bit
    against the plain version, handoffs and decode steps timed); on the
    decode rank, the same trace through the one-process paged and
    continuous engines."""
    import dataclasses
    import statistics
    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.kernels import fused_spec_crossbar as fs
    from repro_torch.kernels import int8_matmul as im
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as lm
    from repro_torch.launch.serve import calibration_tokens
    from repro_torch.models import pim
    from repro_torch.models import transformer as T
    from repro_torch.serve import ContinuousServeEngine, PagedServeEngine
    cfg0 = configs.get(ARCH)
    t0 = time.perf_counter()
    params = T.init_params(cfg0, seed=0, device="cuda")
    calib = calibration_tokens(cfg0, 16)
    cfgs, plans = {}, {}
    for _, mode, _, _ in DISAGG_RUNS:
        cfgs[mode] = dataclasses.replace(cfg0, pim_mode=mode)
        plans[mode] = pim.compile_pim_params(params, cfgs[mode], calib).plans
    checksums = leaf_checksums({"params": params, "plans": plans})
    torch.cuda.synchronize()
    lines = [dict(scope="model", arch=ARCH, dtype=cfg0.dtype,
                  layers=cfg0.n_layers, setup_s=round(
                      time.perf_counter() - t0, 3),
                  checksummed_leaves=len(checksums))]
    pm, dm = lm.make_disaggregated_meshes((1, 1, 1), (1, 1, 1))
    reqs = serve_requests(cfg0.vocab_size)
    max_len = BLOCK * -(-(max(len(r.prompt) for r in reqs) + 8 + 1)
                        // BLOCK)
    out = dict(checksums=checksums, lines=lines, rows=[], tokens={},
               launches={}, reference={})
    for name, mode, n_blocks, kernel in DISAGG_RUNS:
        kw = dict(n_slots=N_SLOTS, max_len=max_len, prefill_chunk=64,
                  block_size=BLOCK, plans=plans[mode])
        if n_blocks is not None:
            kw["n_blocks"] = n_blocks
        eng = PagedServeEngine(cfgs[mode], params, prefill_mesh=pm,
                               decode_mesh=dm, **kw)
        n_proj = len(step_calls(cfgs[mode], plans[mode]))
        per_call = PER_CALL[mode]
        log, undo = record_first(kernel, per_call[kernel] * n_proj)
        steps = []
        decode = eng._decode_split

        def timed(live, *a, _decode=decode):
            t = time.perf_counter()
            _decode(live, *a)
            if live:
                steps.append(time.perf_counter() - t)
        eng._decode_split = timed
        dist.barrier()
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        try:
            with step_timer(eng):
                outs = eng.run(reqs)
                torch.cuda.synchronize()
        finally:
            undo()
        serve_s = time.perf_counter() - t1
        launches = ops.launch_counts()
        st = eng.stats
        calls = st.prefill_chunks if eng.role == "prefill" \
            else st.decode_steps
        want = {k: per_call.get(k, 0) * n_proj * calls for k in launches}
        if launches != want:
            raise AssertionError(f"{name} {eng.role}: launches {launches}, "
                                 f"want {want}")
        if st.blocks_in_use != 0 or (n_blocks is not None
                                     and st.evictions < 1):
            raise AssertionError(f"{name}: {st}")
        if (eng.state is None) != (eng.role == "prefill"):
            raise AssertionError(f"{name}: the pool is on the wrong slice")
        mod = fs if kernel == "fused_spec_crossbar" else im
        mine = []
        for i, (args, kwa, got) in enumerate(log):
            row = compare(kernel, got, mod.plain(*args, **kwa),
                          site=f"disagg.{name}.{eng.role}.call{i}",
                          B=args[0].shape[0], R=args[0].shape[1],
                          C=(got[0] if isinstance(got, tuple)
                             else got).shape[-1])
            mine.append(row)
        del log
        out["rows"] += mine
        out["tokens"][name] = [o.tokens.tolist() for o in outs]
        out["launches"][name] = launches
        n_h = max(eng.handoffs, 1)
        lines.append(dict(
            mode=name, role=eng.role, serve_s=round(serve_s, 3),
            tokens=sum(len(o.tokens) for o in outs),
            prefill_chunks=st.prefill_chunks, decode_steps=st.decode_steps,
            evictions=st.evictions, admission_waits=st.admission_waits,
            launches=json.dumps({k: v for k, v in launches.items() if v}),
            launches_per_call=json.dumps(
                {k: v / max(calls, 1) for k, v in launches.items() if v}),
            handoffs=eng.handoffs,
            handoff_bytes_per_request=eng.handoff_bytes / n_h,
            handoff_ms_per_request=1e3 * eng.handoff_seconds / n_h,
            handoff_bound_ms=1e3 * eng.handoff_bytes / n_h
            / HBM_BYTES_PER_S,
            decode_step_ms_median=1e3 * statistics.median(steps),
            decode_step_ms_min=1e3 * min(steps),
            prefill_s=round(sum(eng.step_s["prefill"]), 3),
            decode_s=round(sum(eng.step_s["decode"]), 3),
            checked_calls=len(mine), max_abs_err=max(
                r["max_abs_err"] for r in mine),
            pool_on_rank=eng.state is not None))
        del eng, outs
        torch.cuda.empty_cache()
    if rank == DISAGG_WORLD - 1:  # the decode rank: one-process engines
        t1 = time.perf_counter()
        for name, mode, n_blocks, _ in DISAGG_RUNS:
            kw = dict(n_slots=N_SLOTS, max_len=max_len, prefill_chunk=64,
                      plans=plans[mode])
            paged_kw = dict(kw, block_size=BLOCK)
            if n_blocks is not None:
                paged_kw["n_blocks"] = n_blocks
            out["reference"][name] = {
                "paged": [o.tokens.tolist() for o in PagedServeEngine(
                    cfgs[mode], params, **paged_kw).run(reqs)],
                "continuous": [o.tokens.tolist() for o in
                               ContinuousServeEngine(cfgs[mode], params,
                                                     **kw).run(reqs)]}
        lines.append(dict(scope="one-process paged and continuous "
                          "engines on the same trace (reference tokens)",
                          seconds=round(time.perf_counter() - t1, 3)))
    lines.append(dict(scope="rank total", rank_s=round(
        time.perf_counter() - t0, 3)))
    return out


# ----------------------------------------------------------- examples
EXAMPLES = ("quickstart", "serve_quantized", "pim_accuracy_demo")
# run a module as ``python -m`` does, then print the kernels' launches
EXAMPLE_RUNNER = ("import json, runpy, sys\n"
                  "from repro_torch.kernels import ops\n"
                  "runpy.run_module(sys.argv.pop(1), run_name='__main__', "
                  "alter_sys=True)\n"
                  "print('launches ' + json.dumps(ops.launch_counts()))\n")


def phase_examples(ctx: dict) -> None:
    """The port's three last examples as subprocesses on the card
    (``python -m repro_torch.examples.<name>``), run at once: their key
    lines checked, the three's wall time and each one's launches
    printed."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    launches = {}
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", EXAMPLE_RUNNER, f"repro_torch.examples.{name}"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env=env) for name in EXAMPLES}  # all three at once
    try:
        outs = {name: p.communicate(timeout=600)
                for name, p in procs.items()}
    finally:
        for p in procs.values():
            p.kill()
    wall_s = time.perf_counter() - t0
    for name in EXAMPLES:
        text, err = outs[name]
        if procs[name].returncode != 0:
            raise AssertionError(f"example {name} failed:\n{err}")
        ran = json.loads(text.rsplit("launches ", 1)[1])
        checks = check_example(name, text, ran)
        launches[name] = ran
        say("examples", example=name,
            launches=json.dumps({k: v for k, v in ran.items() if v}),
            **checks)
    ctx["examples_launches"] = {
        k: sum(ran[k] for ran in launches.values())
        for k in launches[EXAMPLES[0]]}
    say("examples", ok=True, wall_s=round(wall_s, 3),
        launches=json.dumps(ctx["examples_launches"]))


def check_example(name: str, text: str, launches: dict) -> dict:
    """The key lines of one example's output; raises on a missing one."""
    def find(pattern):
        m = re.search(pattern, text)
        if m is None:
            raise AssertionError(f"{name}: no line matches {pattern!r}:\n"
                                 f"{text}")
        return m
    if name == "quickstart":
        chose = find(r"chose \(([\d, ]+)\) \((\d+) slices/weight\), "
                     r"measured error ([\d.]+)")
        conv = find(r"ADC converts (\d+) vs recovery-only (\d+) \((\d+)% "
                    r"saved\), speculation failure rate ([\d.]+)%")
        rel = re.findall(r"rel error vs float: ([\d.]+)", text)
        find(r"\(CUDA kernel on .*H100")
        find(r"converts/MAC [\d.]+ -> [\d.]+; energy")
        if not (int(conv[1]) < int(conv[2]) and len(rel) == 2):
            raise AssertionError(f"quickstart: {conv.group(0)}, {rel}")
        need = ("fused_crossbar", "fused_spec_crossbar",
                "centered_int8_matmul")
        out = dict(slicing=chose[1].replace(" ", ""),
                   converts=int(conv[1]), recovery_only=int(conv[2]),
                   failure_rate_pct=float(conv[4]),
                   exact_rel_err=float(rel[0]), fast_rel_err=float(rel[1]))
    elif name == "serve_quantized":
        find(r"bf16 engine: \(8, 16\) tokens for 8 requests")
        rel = find(r"LM head \(CUDA kernel on .*\): rel err ([\d.]+)")
        need = ("centered_int8_matmul",)
        out = dict(head_rel_err=float(rel[1]))
    else:
        keys = [line.split(" ", 1)[0] for line in text.splitlines()
                if not line.startswith("launches ")]
        want = ["float_accuracy", "center", "zero",
                "paper_table4_drops_center_vs_zero"]
        if keys != want:
            raise AssertionError(f"pim_accuracy_demo printed {keys}")
        need = ("fused_crossbar", "fused_spec_crossbar")
        out = dict(table4_keys=json.dumps(keys))
    missing = [k for k in need if launches.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"{name} launched no {missing}")
    return out


# ---------------------------------------------------------------- main
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases",
                    default="build,kernels,serve,telemetry,nonideal,disagg,"
                    "examples,train,dist,tp,dryrun,moe,hybrid,encoder,"
                    "decoders,"
                    "paper,timing",
                    help="comma list of phases to run (default: all)")
    args = ap.parse_args()
    phases = args.phases.split(",")
    for needs in ("timing", "telemetry", "nonideal"):
        if needs in phases and "serve" not in phases:
            ap.error(f"--phases {needs} needs serve: it uses the model and "
                     "the plans that the serve phase builds")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an "
              "NVIDIA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    print(toolchain(torch), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows: list = []
    ctx: dict = {}
    kernels = None
    t_start = time.perf_counter()

    def run(name, fn, *a):
        if name not in phases:
            return None
        t0 = time.perf_counter()
        out = fn(*a)
        now = time.perf_counter()
        say("main", ran=name, wall_s=round(now - t0, 1),
            elapsed_s=round(now - t_start, 1))
        return out
    with contextlib.ExitStack() as stack:
        if "dryrun" in phases:  # on the idle host cores from the start
            ctx["sweep"] = stack.enter_context(dryrun_sweep())
        run("build", phase_build)
        run("kernels", phase_kernels, rows)
        run("serve", phase_serve, ctx)
        run("telemetry", phase_telemetry, ctx)
        run("nonideal", phase_nonideal, ctx)
        run("disagg", phase_disagg, ctx, rows)
        run("examples", phase_examples, ctx)
        ctx.pop("qwen", None)  # free qwen's weights before the larger models
        run("train", phase_train)
        run("dist", phase_dist)
        run("tp", phase_tp)
        run("dryrun", phase_dryrun, ctx)
        run("moe", phase_moe, ctx, rows)
        run("hybrid", phase_hybrid, ctx, rows)
        run("encoder", phase_encoder, ctx, rows)
        run("decoders", phase_decoders, ctx, rows)
        run("paper", phase_paper, ctx, rows)
        kernels = run("timing", phase_timing, ctx, rows)
    print(smi, flush=True)  # again, within the tail a log keeps
    if kernels is not None:
        print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
