#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA H100: kernels, server, training,
generation.

    python3 chip_smoke.py

from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit (nvcc). It imports nothing of JAX or of `caduceus_tpu`. Phases, in
order (any failure exits non-zero; nothing is caught and passed over):

1. build the kernels from `caduceus_tpu_torch/csrc` (nvcc, sm_90a; one
   nvcc per source, side by side; `attention_fwd.cu` and
   `attention_bwd.cu` with them): `ssd_fused_fwd.cu` (entry points
   `ssd_fused_fwd` and `ssd_fwd`: prep, segment pre-pass and main pass)
   and `ssd_fused_bwd.cu` (`ssd_fused_bwd` / `ssd_bwd`: prep, pre-pass,
   main pass, head-order g_B / g_C sum; `ssd_conv_bwd`: the streaming
   SiLU + conv adjoint and its fixed-order weight sum), the two scan
   sources and six planted-fault variants (three of the scan kernels, two
   of the conv adjoint, one of the attention forward) and the attention
   kernels' barrier-wait probe (ATTN_POLLS); print build times,
   every compiled kernel's registers, spills and static shared memory, and
   each SSD sub-launch's and attention kernel's dynamic shared memory;
2. hold the forward kernel (y, hN and the chunk carries) against its
   plain PyTorch version (`ops/ssd.py ssd_chunked_fused`) on the card:
   small shapes (fp32 and bf16, both directions, nonzero h_init, L not a
   multiple of the chunk, ngroups 1 and 2) and the main-path geometry
   (H=8, P=64, N=128, K=4, Wc=768, G=4, L=8192: 4 segments of 32
   chunks), by the rule of `caduceus_tpu_torch/kernel_check.py`; faults
   planted in its output at the main geometry (D term dropped, one 16x16
   tile of y or hN wrong, and, in each scan direction, one segment's
   incoming state dropped in the kernels' combine) must fail that check;
3. the same for the backward kernels (`ssd_fused_bwd`: all eight
   gradients against `ssd_chunked_fused_bwd`, nonzero h_init and g_hN),
   each kernel also alone against its own plain version, and four faults
   planted in the backward's outputs at the main geometry (the conv
   transpose's neighbour rows dropped, one 16-row tile of g_dt zeroed,
   g_A scaled by 1+2^-4, one 16x16 tile of g_xBC's B columns zeroed, and
   in each direction one segment's incoming lambda dropped); then the SiLU
   + conv adjoint `ssd_conv_bwd` (#3b) alone against `ops/ssd.py
   conv_silu_bwd`: small shapes (fp32 and bf16, both directions, K 1-4,
   L=4099 over five 1,024-row tiles, Wc 388, and Wc 203 as a column view
   at an odd offset) and the main geometry (G=4, L=8192, Wc=768), with the
   halo of every row tile dropped (the g_pre rows past it, the raw rows
   before it: `CONV_DROP` variant builds) failing the check;
4. hold the whole model on the card against the same model on the CPU
   (same weights, full width, 2 layers, L=2048, fp32 logits);
5. serve the full-width `hg38_mlm_v2` model (16 layers, random weights
   from a seeded torch.Generator) over HTTP, after the warm-up of `cli.py
   serve --warmup` (every bucket 1024 ... 131072 x batch 1, 2, 4, /embed
   and /logits: 48 programs, timed, 32 launches each): /embed and /logits
   at buckets 1024 and 16384 with 1-4 sequences, and one 131,072-token
   /logits; the forward kernel's launch count must be 2 directions x 16
   layers per dispatch, the first /logits request after the warm-up is
   timed against the same request again (bit-equal), and the served bf16
   logits of a 1024-bucket request must equal a direct forward and agree
   with the fp32 model on the CPU;
6. one training step (accum 2) of the full-width model at 2 layers,
   L=2048, fp32, on the card and on the CPU from the same weights and
   batch: loss, grad norm, every gradient and every updated parameter
   must agree, and the card's update must equal AdamW's first step from
   the card's own gradient;
7. train the full-width `hg38_mlm_v2` model (8 layers, remat span 1,
   bf16 over fp32 params) at L=131072: micro-batches of 2 sequences
   (G=4 per SSD call), accum 2, AdamW as `bench.py`; one warm-up step
   and 2 timed steps, finite loss and grad norm, and the launch counts
   pinned per micro-batch;
8. time the kernels at the training shape (G=4, L=131072, bf16) and the
   forward also at G=16 (`bench.py`'s batch of 8 x 2 strands) beside
   their plain versions and bounds, each SSD sub-launch alone beside its
   bytes, #3b also beside the floor of its own traffic and the two PyTorch
   calls that compute its function (`silu_backward` then
   `convolution_backward`, held to the plain version first), and hold the
   timed outputs against the plain versions'; then
   run #1 + #3, #2 + #4 and the v1 scan kernels (#9 + #8 in both
   directions, #7 + #8 with h_init and g_hN, #10) twice on the same inputs
   at the training shape and require every output bit for bit the same;

then the v1 (Mamba-1) model of `configs/hg38_mlm.yaml` and its selective
scan kernels, `selective_scan_fwd.cu` (`selective_scan_fwd`, one
direction; `bidir_scan_fwd`, two) and `selective_scan_bwd.cu`:

9. the forward kernels against the plain forward (`ops/selective_scan.py
   selective_scan`): small shapes (fp32 and bf16, both directions,
   nonzero h_init, L = 200 and 600: one partial 256-row chunk, and two
   and a partial one, with and without D and bias, both entry points, the
   SiLU(z) gate) and the main geometry (d=512, N=16, G=4, L=8192: y, hN,
   carries; gated too), then planted faults that must fail (D term
   dropped, one 16-row x 16-channel y tile zeroed, the reverse set run
   with the forward set's A, and in each scan direction one run's
   incoming state dropped);
10. the backward kernels against `selective_scan_bwd`, all eight outputs,
   nonzero g_hN, small and main geometry, and planted faults (g_A scaled
   by 1+2^-4, one 16x16 tile of g_delta zeroed, the softplus chain
   dropped from g_delta, one cluster's g_B share left out, and in each
   scan direction one run's incoming lam dropped);
11. the 2-layer full-width v1 model, card vs CPU (as 4);
12. serve the full-width 16-layer v1 model: /embed and /logits at bucket
   1024 and one 131,072-token /logits, 16 `bidir_scan_fwd` launches per
   dispatch, served logits equal to a direct forward;
12a. [convert] reference PyTorch checkpoints into the port
   (`caduceus_tpu_torch/convert.py`), from reference-named state dicts of a
   seeded torch.Generator: a v1 Caduceus-PS at hg38_mlm's width saved as
   pytorch_model.bin, read, imported and loaded on the card (its export
   gives the saved tensors back bit for bit), written as a run dir and
   served (a 131,072-token bf16 /logits equal to a direct forward bit for
   bit, 16 #9 launches), 2 layers card vs CPU (as 4); RC equivariance
   through #9 (the imported model) and #1 (hg38_mlm_v2): fp32 at L=16,384
   by the fp32 kernel rule, bf16 at L=131,072 within BF16_MODEL_TOL; a
   mamba-ssm MixerModel (4 layers, unidirectional) through #7 at L=131,072
   and card vs CPU; a HyenaDNA LM at hg38_hyena's width through `attn_fwd`
   at L=16,384 and card vs CPU in fp32 (as 40);
13. the 1-layer v1 train step, card vs CPU (as 6);
14. one accum-2 step of a 2-layer unidirectional v1 model (`MambaMixer`,
   L=8192), which runs `selective_scan_fwd`;
15. train the full-width v1 model as 7: 32 `bidir_scan_fwd` and 32
   `selective_scan_bwd` launches per micro-batch;
16. time the three scan kernels at the training shape beside their plain
   versions, bounds and exp counts, #7 also at the v1 prefill's shape
   (G=1, fp32) and with the SiLU(z) gate, and #8's main pass and g_B /
   g_C share sum each alone beside their bytes, holding the timed
   outputs;

and generation, for the causal models of `cli.py pretrain --model mamba`
(v2: after phase 8, through the unfused SSD forward `ssd_fwd`, TPU kernel
#2, the K = 0 instantiation of `ssd_fused_fwd.cu`; v1: after phase 16,
through `selective_scan_fwd`, #7, chained from the cache):

17. `ssd_fwd` against its plain version (`ops/ssd.py ssd_chunked`): small
   shapes (fp32 and bf16, both directions, nonzero h_init, L not a
   multiple of the chunk, ngroups 1 and 2, x/B/C and dt as strided column
   views) and the main geometry (H=8, P=64, N=128, G=4, L=8192: y, hN,
   carries); planted faults that must fail (D dropped, one 16x16 y tile
   zeroed, h_init ignored);
18. (v2, then v1 after 16) the full-width causal model at 2 layers, fp32:
   `prefill` on the card against the CPU (logits and every cache entry),
   two chained prefills (split inside a chunk and before d_conv rows)
   against one, greedy `generate` of 32 tokens against the CPU's tokens
   and the argmax of the card's full forward;
19. the full-width 16-layer causal model over HTTP: /generate with prompts
   of 1,000 and 131,072 tokens and 64 new tokens; the prefill launches
   its scan kernel 16 times per request and decoding none; a bf16
   prefill's last logits against the full forward's last position
   (BF16_MODEL_TOL); prefill tokens/s at 131,072, decode ms per token at
   batch 1 and 8, /generate latency, each beside its bound; the 131,072
   prefill and /generate timed again with the scan in bf16 (the rule
   before the bf16 prefill scanned in fp32, as the JAX prefill does);
20. `ssd_fwd` per call at G=1 and G=4, L=131072, bf16, and at G=1 in
   fp32 (the prefill's scan dtype), beside its plain version and bound;

and, after 16, the last four TPU kernels: the unfused SSD adjoint `ssd_bwd`
(the K = 0 instantiation of `ssd_fused_bwd.cu`'s SSD adjoint; #4 behind
`ops/ssd_batched.py ssd_batched_chained`, #6 behind `ops/ssd_head.py`), the
per-head route of ``use_kernel: pallas`` (#5 / #6), and the paired scan
adjoint `bidir_scan_bwd` (#10):

21. `ssd_bwd` against `ssd_chunked_bwd`, all eight gradients: small shapes
   (fp32 and bf16, both directions, ngroups 1 and 2, strided column views,
   nonzero h_init and g_hN, L not a multiple of the chunk) and the main
   geometry; planted faults that must fail (g_h0 left at zero, g_A x
   (1+2^-4), a 16-row tile of g_dt zeroed, a 16x16 tile of g_B zeroed);
22. two chained `ssd_batched_chained` calls (split inside a chunk) against
   one call under autograd: y, hN and every gradient, g_h0 among them;
23. the 2-layer full-width `use_kernel: pallas` model, card vs CPU (as 4),
   and its train step (as 6), 32 + 16 per-head launches per micro-batch;
24. that model at 8 layers trained at L=131072 (as 7): 32 `ssd_head_fwd`
   and 16 `ssd_head_bwd` launches per micro-batch, no fused kernel;
25. the 16-layer `use_kernel: pallas` model served: a 131,072-token /logits,
   32 `ssd_head_fwd` launches per dispatch, logits equal a direct forward;
26. the 2-layer causal `use_kernel: pallas` model's prefill, card vs CPU
   (as 18), through `ssd_head_fwd`;
27. `bidir_scan_bwd` against the two-launch backward and the plain adjoints,
   small shapes and d=512, N=16, G=4, L=8192; planted faults (the reverse
   set given the forward set's g_y, a 16-channel tile of g_u zeroed);
28. with CADUCEUS_BIDIR_BWD=1: the 1-layer v1 train step card vs CPU, and
   the full-width 16-layer v1 model trained at L=131072 (as 15) with 16
   `bidir_scan_bwd` and no `selective_scan_bwd` launches per micro-batch;
29. `ssd_head_fwd`, `ssd_bwd` / `ssd_head_bwd` and `bidir_scan_bwd` at the
   training shape (G=4, L=131072, bf16) beside their plain versions and
   bounds, holding the timed outputs.

and, last, pretraining through the port's own loop (`cli.py pretrain`: the
hg38 loader, `Trainer`, checkpoints) on a synthetic genome of 2 contigs of
2^23 bases in 2^20-base windows, written into a temporary directory:

30. the Python and the native loader (built from `native/dataloader.cc`
   with g++) timed per batch of 4 x 131,072 tokens; whether `tensorstore`
   and `yaml` import here;
31. the bare `make_train_step` at the loop's geometry: 7's step;
32. `hg38_mlm_v2` at 8 layers, L=131072, 4 sequences in 2 micro-batches,
   4 steps, EMA, a checkpoint every 2 steps, an eval at step 4: run A
   through `cli.main` in this process (its launches counted: the loop runs
   the kernels of 7 and the eval's forwards), run B with the native loader
   in a subprocess, SIGKILLed once its step-2 checkpoint is in place and
   run again with ``--resume``; B's logged loss, acc, grad_norm and lr at
   every step, its eval and its final parameters and EMA must equal A's
   bit for bit; the loop's step against the bare step;
33. `cli.py eval` of run A's test split (finite), and run A, which holds
   only checkpoints, served: a 1,024-token /logits equal to a direct
   forward of the checkpoint's EMA weights;
34. 32 for the v1 model at 4 layers;

and, downstream of run A of each family (the same temporary directory):

35. #1 + #3a/#3b and #9 + #8 at the fine-tuning shape, G=256 (128
   sequences x 2 strands) and L=251, full width, bf16, both directions,
   against their plain versions, then each timed beside its bound there;
36. `cli.py finetune` with the `human_nontata_promoters` preset (L=251,
   batch 128, 2 classes, lr 1e-3, metric all) on a
   `make_structured_classification_suite` task over the synthetic genome
   (1,024 training sequences), from v2 run A (8 layers): 2 epochs, seeds 1
   and 2, ``--save-dir``; launches against the config's count, every
   logged loss finite; the step timed (sequences/s, peak memory); one step
   card vs CPU at 2 layers in fp32; `finetune_one` for seed 1 twice, bit for
   bit; then v1 run A (4 layers), 1 epoch, seed 1;
37. the export served (`cli.py serve`'s service): /classify of 8
   sequences equal to a direct forward bit for bit, latency at 1 sequence
   and at 8 concurrent requests;
38. `cli.py vep --svm` on v2 run A at seq_len 131,072, batch 2, 16
   variants and one with a wrong reference base: 16 feature rows, the
   peak-memory line once, the first variant equal to a direct forward bit
   for bit, the SVM eval on the card (`caduceus_tpu_torch/svm.py`, no
   scikit-learn) printed last; then v1 run A; then [svm]: the SVM fit at
   8,192 rows of 512 features (the v2 dump's width) timed twice, its KKT
   gap, box and equality recomputed in float64 on the card apart from the
   solver (`torch.cdist`), and at 1,024 rows the card's decision values
   against the CPU's solve of the same problem, and the card's fit with
   kernel rows computed on demand (the Gram budget at 0) against both;
39. [attn_kernels] the flash-attention kernels of the hybrid Hyena layers
   (`attn_fwd`, `attn_bwd_dkv`, `attn_bwd_dq`; TPU kernel #11) against
   their plain versions (`ops/attention.py attention_fwd_plain` /
   `attention_bwd_plain`) by the kernel rule with a per-row floor: L 251
   (ragged), 256 and 1000 (ragged, several tiles each way), causal and
   not, fp32 and bf16, head widths 32 and 64, q, k, v also as strided
   views of one packed tensor, each run twice for its bits; the planted
   fault (the second key tile skipped, the ATTN_DROP build), which must
   fail; the path shape (G=2, L=65,536, H=8, hd=32, bf16, causal) against
   the chunked plain version and across two runs, and the planted fault
   there, which must fail too; the largest poll count any one barrier
   wait takes there (the ATTN_POLLS build, whose outputs must equal the
   shipped kernels'); each kernel timed there beside its bound
   (the larger of bytes, FLOPs and exps), its plain version and one SDPA
   call (yardstick), and the forward and the adjoint pair held against
   one SDPA call each;
40. [hyena_vs_cpu] the hybrid Hyena LM (d_model 256, 2 layers, MHA at 1,
   fp32, L=2048) on the card against the CPU: logits and gradients;
41. [hyena_pretrain] `cli.py pretrain --model hyena --ntp` at
   configs/hg38_hyena.yaml's width (8 layers, MHA at 1 and 5), L=65,536,
   4 sequences in 2 micro-batches, 3 steps, `--hyena-checkpoint`, the
   attention launches counted; a run SIGKILLed after its step-2
   checkpoint and resumed equals it bit for bit; `cli.py eval`;
42. [hyena_finetune] `cli.py finetune` from that run (the preset
   human_nontata_promoters, L=251) and `--model cnn`, /classify of both
   exports equal to a direct forward bit for bit;
43. [cp_kernels] the context-parallel entry of #1 / #3a / #3b
   (`ssd_batched_fused_cp`: edge_hist in, its gradient g_edge out): a
   sequence cut into 2 and 4 shards (each given the neighbour's raw rows
   as edge_hist and the previous shard's hN as h_init) against the unsplit
   kernel, forward and through the backward (g_xBC, g_conv_w, g_h0); one
   shard against the plain version with its edge rows (all outputs, g_edge
   included); an all-zero edge_hist bit-equal to the entry without it; the
   planted fault of edge rows read as zeros, which must fail; G=2, L=2048
   (fp32, bf16) and the CP shape G=2, two shards of 131,072 rows (bf16),
   both directions; the adjoint with h_init and a final-state cotangent
   and g_y = 0 (pass 1 of the two-pass scan) at the CP shape; #1 / #3a /
   #3b timed there with and without edge_hist, beside their bounds;
44. [cp_train] `python -m torch.distributed.run --nproc_per_node 2
   chip_smoke.py --rank-job JOB`: two ranks on this card (gloo), the
   sequence of 262,144 rows sharded over them: the first step of v2 at 2
   layers fp32, v2 `hg38_mlm_v2` at 8 layers (16 before the
   tensor-parallel phases came) and v1 `hg38_mlm` at 4 layers (bf16) held
   against one rank's step on the same weights and batch; `cli.py
   pretrain --mesh-model 2 --context-parallel` of each bf16
   model for 2 steps, the CP kernels' launches counted on each rank; a
   step of v2 at 2 layers fp32 with GPN loss weights against one rank's;
   the non-RCPS v2 backbone (2 layers fp32) given ``inputs_embeds`` on the
   two ranks against one rank (hidden states, the gradients of sum(h R)
   for the embeddings and the parameters);
45. [cp_eval] `cli.py eval --mesh-model 2 --context-parallel` of the v2 run
   against `cli.py eval` on one rank; the eval step on the two ranks with
   loss weights, per_token and last_k 196,608 (both ranks), 65,536 (the
   last rank's columns) and 262,145 (the whole row), at 2 layers fp32 and
   at 8 layers bf16, against the same step on one rank;
46. [dp_train] two ranks, data parallelism over a global batch of 2 x
   131,072: the first step at 2 layers fp32 (also with loss weights) and 8
   layers bf16 against one rank's (loss and updated parameters), `cli.py
   pretrain` for 2 steps and a resume from its step-1 checkpoint that
   replays step 2 bit for bit;
47. [tp_kernels] the kernels of the tensor-parallel paths at one rank's
   shapes (model axis 2): #9, #7, #8 at 256 channels, #2 / #4 and #5 / #6
   at 4 heads (G=4, L=131072), the CP entry of #1 / #3a / #3b at 4 heads
   (G=2, L_loc=131072) and #11 at 4 heads (G=2, L=65536), each against
   its plain version and timed beside its bound;
48. [tp_train] two ranks, the model cut over them: the first step of v2
   (2 layers fp32, 4 layers bf16), v1 (4 layers) and the Hyena LM (8
   layers, L=65536, dropout off) against one rank's, every model rank's
   shared gradients equal; `cli.py pretrain --mesh-model 2
   --tensor-parallel` of v2 for 2 steps, its resume from checkpoint 1 bit
   for bit, and `cli.py eval` on two ranks against one;
49. [cp_tp] four ranks, data 1 x model 2 x seq 2: v2 with its heads over
   'model' and its sequence over 'seq', forward and the gradients of
   sum(logits^2) against one rank's model (4 layers bf16 at L=262144 and
   2 layers fp32 through the fused route, 2 layers fp32 through the
   unfused composed route);
50. [vep_ranks] `cli.py vep` of [vep]'s run dir over two processes, every
   variant's row against [vep]'s one-process row.

``--only cp`` runs the build and phases 43-46 alone, ``--only hyena`` the
build and phases 39-42, ``--only convert`` the build and 12a, ``--only
tp`` the build, phases 47-50 and the [vep] run they compare with,
``--only serve`` the build and phase 5, ``--only svm`` [svm] alone (no
kernel, no build) (for work on them); the ranks of phases 44-46 and 48-50
run this script with ``--rank-job``.

Prints every measurement as one `[report]` JSON line, then a `kernels`
JSON line, the card's name and power limit, and last
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import urllib.request
from unittest import mock

import numpy as np
import torch

MODEL_TOL = 1e-3       # card vs CPU logits, fp32, 2 layers, normalized
# card vs CPU training step, fp32, 2 layers (both sides sum in other
# orders): loss and grad norm relative; each gradient against its largest
# element; each updated parameter in units of (1 + |p|) where the gradient
# is above `settled` x its largest and above `adam_floor` (Adam's first
# step is lr·g/(|g| + eps), eps = 1e-8: at a gradient near 0 its sign
# decides, and within 100 eps of 0 its size turns on the last digits of g,
# so there the bound is 2·lr), and every updated parameter, in the same
# units, against AdamW's first step computed in fp64 from the card's own
# gradient
TRAIN_TOL = {"metric": 1e-5, "grad": 1e-4, "param": 1e-6, "settled": 1e-3,
             "adam_floor": 1e-6}
# served bf16 logits vs the fp32 CPU model, 16 layers, normalized: a few
# bf16 roundings (2^-8 each) per layer, compounded over 16 layers
BF16_MODEL_TOL = 5e-2
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12       # dense tensor-core bf16
FP32_FLOP_PER_S = 67e12        # fp32 outside the tensor cores


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str):
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str):
    print(msg, flush=True)


def hg38_mlm_v2_config(n_layer: int = 16, dtype: str = "bfloat16",
                       use_kernel: str = "auto"):
    """`configs/hg38_mlm_v2.yaml`'s model, written out (no YAML)."""
    from caduceus_tpu_torch.config import CaduceusConfig, SSMConfig
    from caduceus_tpu_torch.tokenization import CaduceusTokenizer

    tok = CaduceusTokenizer()
    return CaduceusConfig(
        d_model=256, n_layer=n_layer, vocab_size=tok.vocab_size,
        rcps=True, complement_map=tok.complement_map, bidirectional=True,
        bidirectional_strategy="add", bidirectional_weight_tie=True,
        rms_norm=True, residual_in_fp32=False, fused_add_norm=True,
        dtype=dtype, param_dtype="float32", remat=True, remat_span=1,
        ssm_cfg=SSMConfig(version=2, d_state=128, headdim=64, ngroups=1,
                          d_conv=4, expand=2, ssd_chunk_size=128,
                          ssd_seg_chunks=8, use_kernel=use_kernel))


def hg38_mlm_v2_pallas_config(n_layer: int = 16, dtype: str = "bfloat16"):
    """The same model with ``ssm_cfg.use_kernel = "pallas"``: the per-head
    route (conv + SiLU as a PyTorch op, then `ops/ssd_head.py ssd_head`:
    TPU kernels #5 / #6)."""
    return hg38_mlm_v2_config(n_layer, dtype, use_kernel="pallas")


def ssd_inputs(G, L, H, P, NG, N, K, dtype, seed, width_pad=0):
    """Seeded kernel inputs on the card, with the backward's cotangents
    g_y and g_hN. With ``width_pad`` xBC and dt are column slices of one
    wider tensor, as the mixer's in_proj split gives them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    Wc = H * P + 2 * NG * N

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    wide = rnd(G, L, width_pad + Wc + H)
    wide[..., width_pad + Wc:] *= 0.5
    wide = wide.to(dtype)
    xBC = wide[..., width_pad:width_pad + Wc]
    dt = wide[..., width_pad + Wc:]
    if width_pad == 0:
        xBC, dt = xBC.contiguous(), dt.contiguous()
    return dict(
        xBC=xBC, dt=dt, A=-torch.exp(rnd(H, scale=0.5)),
        conv_w=rnd(K, Wc, scale=0.5), conv_b=rnd(Wc, scale=0.1),
        D=rnd(H), dt_bias=rnd(H, scale=0.1),
        h_init=rnd(G, H, N, P), dims=(H, P, NG, N),
        g_y=rnd(G, L, H, P).to(dtype), g_hN=rnd(G, H, N, P))


_KERNEL_NAMES = ("ssd_prep_kernel", "ssd_fwd_state_kernel", "ssd_fwd_kernel",
                 "ssd_bwd_state_kernel", "ssd_fused_bwd_kernel",
                 "ssd_share_sum_kernel", "ssd_conv_bwd_kernel",
                 "ssd_conv_wsum_kernel", "selective_scan_fwd_kernel",
                 "selective_scan_bwd_kernel", "bc_share_sum_kernel",
                 "attn_fwd_kernel", "attn_bwd_dkv_kernel",
                 "attn_bwd_dq_kernel", "attn_delta_kernel",
                 "attn_fwd_wgmma_kernel", "attn_bwd_dkv_wgmma_kernel",
                 "attn_bwd_dq_wgmma_kernel")


def _instantiation(mangled: str) -> str:
    """A readable name of one compiled kernel: its name, storage type,
    conv width K and scan direction (SSD), or d_state N, gate and warps per
    block (scan), from the mangled symbol."""
    import re

    name = next((k for k in _KERNEL_NAMES if k in mangled), mangled)
    tail = mangled.split(name, 1)[-1]
    args = []
    if "bfloat16" in tail or "wgmma" in name:
        args.append("bf16")
    elif re.match(r"I(Li\d+E)?f", tail):
        args.append("fp32")
    ints = re.findall(r"Li(\d+)E", tail)
    if ints:
        var = ("K" if name.startswith("ssd") else
               "hd" if name.startswith("attn") else "N")
        args.append(f"{var}={ints[0]}")
    if name == "selective_scan_fwd_kernel" and len(ints) > 1:
        args.append(f"{ints[1]} warps")
    if "Lb1E" in tail:
        args.append("reverse" if name.startswith("ssd") else "gated")
    return f"{name}<{', '.join(args)}>" if args else name


# the scan kernels' planted faults: variant libraries of the same sources
# built with these defines (`csrc/scan_common.cuh` SCAN_DROP)
DROP_RUN = ("SCAN_DROP=1",)     # one run's incoming state / lam zeroed
DROP_SHARE = ("SCAN_DROP=2",)   # one cluster's g_B share left out
# the conv adjoint's (`csrc/ssd_fused_bwd.cu` CONV_DROP): a row tile's halo
CONV_DROP_AFTER = ("CONV_DROP=1",)   # the g_pre rows past each tile zero
CONV_DROP_BEFORE = ("CONV_DROP=2",)  # the raw rows before each tile zero
# the attention forward's (`csrc/attention_fwd.cu` ATTN_DROP): the second
# key tile skipped
ATTN_DROP = ("ATTN_DROP=1",)
# the attention kernels' barrier-wait probe (`csrc/attention_common.cuh`
# ATTN_POLLS): the waits counted, the largest poll count of one kept
ATTN_POLLS = ("ATTN_POLLS=1",)
PROBE_BUILDS = (("attention_fwd", ATTN_POLLS), ("attention_bwd", ATTN_POLLS))
FAULT_BUILDS = (("selective_scan_fwd", DROP_RUN),
                ("selective_scan_bwd", DROP_RUN),
                ("selective_scan_bwd", DROP_SHARE),
                ("ssd_fused_bwd", CONV_DROP_AFTER),
                ("ssd_fused_bwd", CONV_DROP_BEFORE),
                ("attention_fwd", ATTN_DROP))


def _variant(module, defines):
    """While open, the wrappers of ``module`` launch the variant library
    built with ``defines`` (a planted fault) instead of the shipped one."""
    real = module._fn
    return mock.patch.object(module, "_fn", lambda name: real(name, defines))


def scan_fault(defines):
    """`_variant` of the scan wrappers (`csrc/scan_common.cuh` SCAN_DROP)."""
    from caduceus_tpu_torch.ops import scan

    return _variant(scan, defines)


def phase_build():
    """nvcc of the six sources and of the six planted-fault variants
    (three of the scan kernels, two of the conv adjoint, one of the
    attention forward) side by side; then
    every compiled kernel's registers, static shared memory and spills
    (`-Xptxas -v`), and the dynamic shared memory each SSD sub-launch asks
    for at the main geometry (P=64, N=128) and K = 4 and 0."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor

    from caduceus_tpu_torch import _build

    names = ("ssd_fused_fwd", "ssd_fused_bwd", "selective_scan_fwd",
             "selective_scan_bwd", "attention_fwd", "attention_bwd")
    builds = [(n, ()) for n in names] + list(FAULT_BUILDS) + list(
        PROBE_BUILDS)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        done = list(pool.map(lambda b: _build.build(*b), builds))
    wall = time.perf_counter() - t0
    built = dict(zip(names, done))
    out = {"nvcc_flags": list(_build.NVCC_FLAGS), "wall_s": wall,
           "ptxas": {}, "dynamic_smem": {}}
    for name, (path, secs) in built.items():
        log(f"[build] {name}: {secs:.1f} s -> {os.path.relpath(path)}")
        out[f"{name}_s"] = secs
        with open(path[:-3] + ".log") as f:
            report = f.read().split("Compiling entry function")
        for entry in report[1:]:
            head = entry.split("\n", 1)[0].strip(" '")
            kernel = _instantiation(head)
            used = [ln.strip() for ln in entry.splitlines()
                    if "registers" in ln or "spill" in ln]
            out["ptxas"][kernel] = used
            log(f"[build]   {kernel}: {'; '.join(used)}")
        if name.startswith("attention"):
            lib = ctypes.CDLL(path)
            for entry, which in ((("attn_fwd", None),) if name.endswith(
                    "fwd") else (("attn_bwd_dkv", 0), ("attn_bwd_dq", 1))):
                fn = (lib.attn_fwd_smem if which is None
                      else lib.attn_bwd_smem)
                fn.restype = ctypes.c_longlong
                args = (() if which is None else (which,))
                sizes = {f"{dn} hd={hd}": fn(*args, dt, hd)
                         for dt, dn in ((1, "bf16"), (0, "fp32"))
                         for hd in (32, 128)}
                out["dynamic_smem"][entry] = sizes
                log(f"[build]   {entry} dynamic shared memory per block: "
                    + ", ".join(f"{k} {v:,} B" for k, v in sizes.items()))
        if name.startswith("ssd"):
            fn = getattr(ctypes.CDLL(path), f"{name}_smem")
            fn.restype = ctypes.c_longlong
            fn.argtypes = [ctypes.c_int] * 5
            for dtype, dname in ((1, "bf16"), (0, "fp32")):
                for K in (4, 0):
                    sizes = {part: fn(dtype, K, 64, 128, i) for i, part in
                             enumerate(("prep", "pre-pass", "main pass"))}
                    if name == "ssd_fused_bwd" and K:
                        sizes["conv adjoint block"] = fn(dtype, K, 64, 128, 3)
                    out["dynamic_smem"][f"{name} {dname} K={K}"] = sizes
                    log(f"[build]   {name} {dname} K={K} dynamic shared "
                        f"memory (P=64, N=128): " + ", ".join(
                            f"{k} {v:,} B" for k, v in sizes.items()))
    for (name, defines), (path, secs) in zip(
            FAULT_BUILDS + PROBE_BUILDS, done[len(names):]):
        kind = "planted fault" if (name, defines) in FAULT_BUILDS else "probe"
        log(f"[build] {name} -D{' -D'.join(defines)} ({kind}): "
            f"{secs:.1f} s -> {os.path.relpath(path)}")
    log(f"[build] {len(builds)} libraries in {wall:.1f} s wall")
    return out


def run_pair(inp, reverse, **over):
    """The forward kernel and its plain version on the same card tensors:
    ((y, hN, carries) of the kernel, (y, hN, carries) of the plain
    version). ``over`` replaces inputs of the kernel's run only."""
    from caduceus_tpu_torch.ops.ssd import ssd_chunked_fused
    from caduceus_tpu_torch.ops.ssd_batched import KERNEL_CHUNK, ssd_fused_fwd

    T = KERNEL_CHUNK[inp["xBC"].dtype]
    k = {**inp, **over}
    kernel = ssd_fused_fwd(
        k["xBC"], k["dt"], k["A"], k["conv_w"], k["conv_b"], k["D"],
        k["dt_bias"], k["dims"], True, reverse, T, k["h_init"],
        save_carries=True)
    torch.cuda.synchronize()
    plain = ssd_chunked_fused(
        inp["xBC"], inp["dt"], inp["A"], inp["conv_w"], inp["conv_b"],
        inp["D"], inp["dt_bias"], dims=inp["dims"], dt_softplus=True,
        reverse=reverse, chunk_size=T, h_init=inp["h_init"],
        return_carries=True)
    return kernel, plain


FWD_NAMES = ("y", "hN", "carries")
BWD_NAMES = ("g_xBC", "g_dt", "g_A", "g_conv_w", "g_conv_b", "g_D",
             "g_dt_bias", "g_h0")


def hold(label, tol, kernel, plain, names=FWD_NAMES, expect_ok=True,
         tag="ssd"):
    """Hold each kernel output against the plain version's (see
    `caduceus_tpu_torch/kernel_check.py` for the rule) and require that
    the check passes (``expect_ok``) or, for a planted fault, fails."""
    from caduceus_tpu_torch.kernel_check import compare, describe

    out = {}
    for name, k, p in zip(names, kernel, plain):
        check(k.dtype == p.dtype and k.shape == p.shape,
              f"{label}: {name} is {k.dtype} {tuple(k.shape)}, plain "
              f"{p.dtype} {tuple(p.shape)}")
        check(bool(torch.isfinite(k).all()), f"{label}: non-finite {name}")
        out[name] = compare(k, p, tol)
    ok = all(s["ok"] for s in out.values())
    log(f"[{tag}] {label}: {'pass' if ok else 'FAIL'} (tol rel_l2 "
        f"{tol.rel_l2:.0e}, |err| <= {tol.rtol:.2e}|ref| + {tol.atol:.2e} "
        f"mean|ref|)")
    for name, st in out.items():
        log(f"[{tag}]   {name}: {describe(st)}")
    check(ok == expect_ok, f"{label}: the check "
          f"{'failed' if expect_ok else 'passed a planted fault'}")
    return out


def planted_faults(inp, kernel, plain):
    """Faults planted in the forward kernel's output (or its D term) must
    fail the bf16 check at the main geometry: the check is not too loose
    to see one wrong 16x16 tensor-core tile."""
    from caduceus_tpu_torch.kernel_check import TOL

    y_k, h_k, c_k = kernel
    res = {}
    no_d, _ = run_pair(inp, False, D=torch.zeros_like(inp["D"]))
    t0 = 37 * 64 + 16                     # rows 16..31 of chunk 37
    faults = {"D term dropped": (no_d[0], h_k, c_k)}
    y = y_k.clone()
    y[1, t0:t0 + 16, 5, 48:64] = 0
    faults["one y tile (g1, h5, p48-63) zeroed"] = (y, h_k, c_k)
    y = y_k.clone()
    y[1, t0:t0 + 16, 5, 48:64] *= 1 + 2 ** -4
    faults["one y tile scaled by 1+2^-4"] = (y, h_k, c_k)
    h = h_k.clone()
    h[2, 3, 112:128, 48:64] = 0
    faults["one hN tile (g2, h3, n112-127, p48-63) zeroed"] = (y_k, h, c_k)
    for name, out in faults.items():
        res[name] = hold(f"planted fault: {name}", TOL[torch.bfloat16], out,
                         plain, expect_ok=False)
    return res


def _second_segment(S, reverse):
    """The array index of the segment the scan passes second: dropping its
    pre-pass output hands the third segment a zero incoming state."""
    check(S >= 3, f"{S} segments: the segment faults need 3 or more")
    return S - 2 if reverse else 1


def drop_segment_fwd(inp, reverse):
    """The forward kernels (y, hN, carries) with one segment's incoming
    state dropped: after the prep and the pre-pass, the state of the
    segment the scan passes second is set to 0 and its sum of a to -inf, so
    the combine hands the next segment a zero state."""
    from caduceus_tpu_torch.ops import ssd_batched as sb

    T = sb.KERNEL_CHUNK[inp["xBC"].dtype]
    a = (inp["xBC"], inp["dt"], inp["A"], inp["conv_w"], inp["conv_b"],
         inp["D"], inp["dt_bias"], inp["dims"], True, reverse, T,
         inp["h_init"], True)
    ws = sb.fused_fwd_call(*a, parts=sb.PART_PREP | sb.PART_STATE)[3]
    j = _second_segment(ws["S"], reverse)
    ws["seg"][:, :, j] = 0
    ws["seg_a"][:, :, j] = -math.inf
    return sb.fused_fwd_call(*a, parts=sb.PART_MAIN, ws=ws)[:3]


def drop_segment_bwd(inp, reverse, car):
    """The backward kernels' eight gradients with one segment's incoming
    lambda dropped (as `drop_segment_fwd`, on the adjoint's pre-pass)."""
    from caduceus_tpu_torch.ops import ssd_batched as sb

    T = sb.KERNEL_CHUNK[inp["xBC"].dtype]
    a = (inp["xBC"], inp["dt"], inp["A"], inp["conv_w"], inp["conv_b"],
         inp["D"], inp["dt_bias"], inp["g_y"], car, inp["g_hN"], inp["dims"],
         True, reverse, T)
    ws = sb.adjoint_xc_call(*a, parts=sb.PART_PREP | sb.PART_STATE)[1]
    j = _second_segment(ws["S"], not reverse)
    ws["seg"][:, :, j] = 0
    ws["seg_a"][:, :, j] = -math.inf
    (g_xc, g_dt, g_A, g_D, g_bias, g_h0), _ = sb.adjoint_xc_call(
        *a, parts=sb.PART_MAIN | sb.PART_SUM, ws=ws)
    g_xBC, g_w, g_b = sb.conv_silu_bwd(g_xc, inp["xBC"], inp["conv_w"],
                                       inp["conv_b"], reverse)
    return g_xBC, g_dt, g_A, g_w, g_b, g_D, g_bias, g_h0


def phase_kernel_checks():
    from caduceus_tpu_torch.kernel_check import TOL

    results = []
    seed = 0
    for dtype in (torch.float32, torch.bfloat16):
        for NG in (1, 2):
            for reverse in (False, True):
                seed += 1
                inp = ssd_inputs(2, 200, 4, 32, NG, 32, 4, dtype, seed,
                                 width_pad=16 if reverse else 0)
                label = (f"fwd small G=2 L=200 H=4 P=32 NG={NG} N=32 "
                         f"{str(dtype)[6:]} rev={reverse}")
                results.append({"case": label, **hold(
                    label, TOL[dtype], *run_pair(inp, reverse))})
    faults = None
    for dtype, reverse in ((torch.bfloat16, False), (torch.bfloat16, True),
                           (torch.float32, False)):
        seed += 1
        # columns 512.. of a 1288-wide in_proj output, as in the model
        inp = ssd_inputs(4, 8192, 8, 64, 1, 128, 4, dtype, seed,
                         width_pad=512)
        label = (f"fwd main G=4 L=8192 H=8 P=64 N=128 {str(dtype)[6:]} "
                 f"rev={reverse}")
        kernel, plain = run_pair(inp, reverse)
        results.append({"case": label, **hold(label, TOL[dtype], kernel,
                                              plain)})
        if faults is None:
            faults = planted_faults(inp, kernel, plain)
        if dtype == torch.bfloat16:
            name = f"segment's incoming state dropped, rev={reverse}"
            faults[name] = hold(f"planted fault: {name}", TOL[dtype],
                                drop_segment_fwd(inp, reverse), plain,
                                expect_ok=False)
        del inp, kernel, plain
    return results, faults


def bwd_pair(inp, reverse):
    """The backward kernels and their plain version on the same inputs and
    the same carries (the forward kernel's): (kernel's eight gradients,
    plain version's, carries)."""
    from caduceus_tpu_torch.ops.ssd import ssd_chunked_fused_bwd
    from caduceus_tpu_torch.ops.ssd_batched import (
        KERNEL_CHUNK, ssd_fused_bwd, ssd_fused_fwd)

    T = KERNEL_CHUNK[inp["xBC"].dtype]
    args = (inp["xBC"], inp["dt"], inp["A"], inp["conv_w"], inp["conv_b"],
            inp["D"], inp["dt_bias"])
    _, _, car = ssd_fused_fwd(*args, inp["dims"], True, reverse, T,
                              inp["h_init"], save_carries=True)
    kernel = ssd_fused_bwd(*args, inp["g_y"], car, inp["g_hN"], inp["dims"],
                           True, reverse, T)
    torch.cuda.synchronize()
    plain = ssd_chunked_fused_bwd(*args, inp["g_y"], car, inp["g_hN"],
                                  inp["dims"], True, reverse, T)
    return kernel, plain, car


def bwd_planted_faults(inp, kernel, plain):
    """Faults planted in the backward's outputs at the main geometry
    (bf16, forward direction) must fail the check."""
    from caduceus_tpu_torch.kernel_check import TOL
    from caduceus_tpu_torch.ops.conv import causal_conv1d
    from caduceus_tpu_torch.ops.ssd import ssd_adjoint_xc
    from caduceus_tpu_torch.ops.ssd_batched import KERNEL_CHUNK

    H, P, NG, N = inp["dims"]
    K = inp["conv_w"].shape[0]
    t0 = 37 * 64 + 16                     # rows 16..31 of chunk 37
    faults = {}
    # the conv transpose without its neighbour rows: g_xBC[j] = w[K-1]
    # g_pre[j] only, g_pre from the plain version's d loss / d silu(pre)
    g_xc = ssd_adjoint_xc(
        inp["xBC"], inp["dt"], inp["A"], inp["conv_w"], inp["conv_b"],
        inp["D"], inp["dt_bias"], inp["g_y"], plain[-1], inp["g_hN"],
        inp["dims"], True, False, KERNEL_CHUNK[torch.bfloat16])[0]
    pre = causal_conv1d(inp["xBC"].float(), inp["conv_w"], inp["conv_b"],
                        activation=None)
    sig = torch.sigmoid(pre)
    own = inp["conv_w"][K - 1] * g_xc * sig * (1 + pre * (1 - sig))
    del g_xc, pre, sig
    faults["conv transpose: neighbour rows dropped"] = (
        (own.to(kernel[0].dtype),) + kernel[1:])
    del own
    g_dt = kernel[1].clone()
    g_dt[1, t0:t0 + 16, 5] = 0
    faults["one 16-row tile of g_dt (g1, h5) zeroed"] = (
        kernel[:1] + (g_dt,) + kernel[2:])
    faults["g_A scaled by 1+2^-4"] = (
        kernel[:2] + (kernel[2] * (1 + 2 ** -4),) + kernel[3:])
    g_x = kernel[0].clone()
    g_x[1, t0:t0 + 16, H * P + 16:H * P + 32] = 0
    faults["one 16x16 tile of g_xBC's B columns zeroed"] = (
        (g_x,) + kernel[1:])
    res = {}
    for name, out in faults.items():
        res[name] = hold(f"planted fault: {name}", TOL[torch.bfloat16],
                         out, plain[:-1], BWD_NAMES, expect_ok=False,
                         tag="bwd")
    return res


def phase_bwd_checks():
    from caduceus_tpu_torch.kernel_check import TOL

    results = []
    seed = 100
    for dtype in (torch.float32, torch.bfloat16):
        for NG in (1, 2):
            for reverse in (False, True):
                seed += 1
                inp = ssd_inputs(2, 200, 4, 32, NG, 32, 4, dtype, seed,
                                 width_pad=16 if reverse else 0)
                label = (f"bwd small G=2 L=200 H=4 P=32 NG={NG} N=32 "
                         f"{str(dtype)[6:]} rev={reverse}")
                kernel, plain, _ = bwd_pair(inp, reverse)
                results.append({"case": label, **hold(
                    label, TOL[dtype], kernel, plain, BWD_NAMES,
                    tag="bwd")})
    faults = None
    for dtype, reverse in ((torch.bfloat16, False), (torch.bfloat16, True),
                           (torch.float32, False)):
        seed += 1
        inp = ssd_inputs(4, 8192, 8, 64, 1, 128, 4, dtype, seed,
                         width_pad=512)
        label = (f"bwd main G=4 L=8192 H=8 P=64 N=128 {str(dtype)[6:]} "
                 f"rev={reverse}")
        kernel, plain, car = bwd_pair(inp, reverse)
        results.append({"case": label, **hold(
            label, TOL[dtype], kernel, plain, BWD_NAMES, tag="bwd")})
        if faults is None:
            faults = bwd_planted_faults(inp, kernel, plain + (car,))
        if dtype == torch.bfloat16:
            name = f"segment's incoming lambda dropped, rev={reverse}"
            faults[name] = hold(f"planted fault: {name}", TOL[dtype],
                                drop_segment_bwd(inp, reverse, car), plain,
                                BWD_NAMES, expect_ok=False, tag="bwd")
        del inp, kernel, plain, car
    return results, faults


def conv_inputs(G, L, Wc, K, dtype, seed, pad=None):
    """The conv adjoint's inputs on the card: g_xc (fp32), xBC (contiguous,
    or a column view at offset ``pad`` of a wider row), conv_w, conv_b."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s, sc=1.0: torch.randn(*s, generator=g, device="cuda") * sc
    wide = rnd(G, L, (pad or 0) + Wc + 8).to(dtype)
    xBC = (wide[..., :Wc].contiguous() if pad is None
           else wide[..., pad:pad + Wc])
    return rnd(G, L, Wc), xBC, rnd(K, Wc, sc=0.5), rnd(Wc, sc=0.1)


CONV_NAMES = ("g_xBC", "g_conv_w", "g_conv_b")


def conv_pair(args, reverse, fault=()):
    """`ssd_conv_bwd` (or a planted fault's build of it) and its plain
    version, `ops/ssd.py conv_silu_bwd`, on the same tensors."""
    from caduceus_tpu_torch.ops import ssd_batched as sb
    from caduceus_tpu_torch.ops.ssd import conv_silu_bwd

    with _variant(sb, fault) if fault else contextlib.nullcontext():
        kernel = sb.conv_silu_bwd(*args, reverse)
    torch.cuda.synchronize()
    return kernel, conv_silu_bwd(*args, reverse)


def phase_conv_checks():
    """#3b alone (`ssd_conv_bwd`, the SiLU + conv adjoint) against its
    plain version: small shapes (fp32 and bf16, both directions, K 1-4,
    L=4099: four 1,024-row tiles and a ragged fifth; Wc 388 contiguous, and
    Wc 203 as a column view at an odd offset, which takes the scalar path)
    and the main geometry (G=4, L=8192, Wc=768 in a 1288-wide row, bf16
    both directions, fp32); then the halo of every row tile dropped (the
    g_pre rows past it, the raw rows before it: variant builds), which
    must fail."""
    from caduceus_tpu_torch.kernel_check import TOL

    results, faults = [], {}
    seed = 300
    for dtype in (torch.float32, torch.bfloat16):
        for reverse in (False, True):
            for K in (1, 2, 3, 4):
                for Wc, pad in ((388, None), (203, 5)):
                    seed += 1
                    label = (f"conv small G=2 L=4099 Wc={Wc} K={K} "
                             f"{str(dtype)[6:]} rev={reverse}")
                    args = conv_inputs(2, 4099, Wc, K, dtype, seed, pad)
                    results.append({"case": label, **hold(
                        label, TOL[dtype], *conv_pair(args, reverse),
                        CONV_NAMES, tag="conv")})
    for dtype, reverse in ((torch.bfloat16, False), (torch.bfloat16, True),
                           (torch.float32, False)):
        seed += 1
        args = conv_inputs(4, 8192, 768, 4, dtype, seed, pad=512)
        label = f"conv main G=4 L=8192 Wc=768 {str(dtype)[6:]} rev={reverse}"
        kernel, plain = conv_pair(args, reverse)
        results.append({"case": label, **hold(
            label, TOL[dtype], kernel, plain, CONV_NAMES, tag="conv")})
        if dtype == torch.bfloat16:
            for what, fault in (("g_pre rows past", CONV_DROP_AFTER),
                                ("raw rows before", CONV_DROP_BEFORE)):
                name = f"the {what} each row tile dropped, rev={reverse}"
                faults[name] = hold(
                    f"planted fault: {name}", TOL[dtype],
                    conv_pair(args, reverse, fault)[0], plain, CONV_NAMES,
                    expect_ok=False, tag="conv")
        del args, kernel, plain
    return results, faults


def phase_model_vs_cpu(config=None):
    from caduceus_tpu_torch.models.caduceus import CaduceusForMaskedLM

    config = config or hg38_mlm_v2_config
    cfg = config(n_layer=2, dtype="float32")
    gen = torch.Generator().manual_seed(1234)
    cpu = CaduceusForMaskedLM(cfg, device="cpu", generator=gen)
    card = CaduceusForMaskedLM(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    ids = torch.randint(7, 11, (1, 2048), generator=gen)
    with torch.inference_mode():
        t0 = time.perf_counter()
        ref = cpu(ids)
        t_cpu = time.perf_counter() - t0
        got = card(ids.cuda())
        torch.cuda.synchronize()
    got = got.cpu()
    check(got.shape == ref.shape == (1, 2048, cfg.padded_vocab_size),
          f"model logits shape {tuple(got.shape)}")
    check(bool(torch.isfinite(got).all()), "model logits not finite")
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    rel_l2 = ((got - ref).norm() / ref.norm()).item()
    check(err <= MODEL_TOL * scale,
          f"card vs CPU logits: {err:.3e} > {MODEL_TOL} x {scale:.3e}")
    log(f"[model] {config.__name__[:-7]}: card vs CPU, full width, 2 layers, "
        f"L=2048, fp32: max err "
        f"{err:.3e} (max|logit| {scale:.3e}, tol {MODEL_TOL} normalized), "
        f"rel_l2 {rel_l2:.2e}; CPU forward {t_cpu:.2f} s")
    return {"max_abs_err": err, "max_abs_ref": scale, "rel_l2": rel_l2}


def _post(port, path, obj, timeout=600):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def phase_serve():
    from caduceus_tpu_torch.models.caduceus import CaduceusForMaskedLM
    from caduceus_tpu_torch.ops import ssd_batched
    from caduceus_tpu_torch.serve import InferenceServer, InferenceService

    cfg = hg38_mlm_v2_config()
    model = CaduceusForMaskedLM(
        cfg, device="cpu", generator=torch.Generator().manual_seed(2222))
    svc = InferenceService(cfg, model.state_dict(), device="cuda",
                           max_batch=4, min_bucket=1024, max_length=131072)
    del model
    # `cli.py serve --warmup`: every (bucket, batch) signature the server
    # answers, run once before the socket listens
    ssd_batched.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_warm = svc.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm_launches = ssd_batched.launches
    n_sig = 8 * 3        # buckets 1024 ... 131072 x batch sizes 1, 2, 4
    log(f"[serve] warm-up: {n_warm} programs ({n_sig} bucket x batch "
        f"signatures, /embed and /logits each) in {warm_s:.2f} s, "
        f"{warm_launches} ssd_fused_fwd launches")
    check(n_warm == 2 * n_sig, f"warm-up counted {n_warm} != {2 * n_sig}")
    check(warm_launches == 2 * cfg.n_layer * n_warm,
          f"warm-up launches {warm_launches} != {2 * cfg.n_layer} x {n_warm}")
    server = InferenceServer(svc, port=0).start()
    rng = np.random.default_rng(7)

    def seqs(*lengths):
        return ["".join(rng.choice(list("ACGT"), n)) for n in lengths]

    plan = [
        ("/embed", seqs(1000)),
        ("/logits", seqs(900, 1024)),
        ("/embed", seqs(16384, 12000, 9000, 16000)),
        ("/logits", seqs(16384, 10000, 13000)),
        ("/logits", seqs(131072)),
    ]
    requests = []
    try:
        torch.cuda.reset_peak_memory_stats()
        d0 = svc.n_dispatches
        ssd_batched.launches = 0
        for path, batch in plan:
            t0 = time.perf_counter()
            out = _post(server.port, path, {"sequences": batch})[path[1:]]
            dt = time.perf_counter() - t0
            ntok = sum(map(len, batch))
            for s, o in zip(batch, out):
                a = np.asarray(o, np.float32)
                want = ((cfg.d_model,) if path == "/embed"
                        else (len(s), cfg.padded_vocab_size))
                check(a.shape == want, f"{path}: shape {a.shape} != {want}")
                check(bool(np.isfinite(a).all()), f"{path}: non-finite")
            requests.append({"path": path, "n_seq": len(batch),
                             "tokens": ntok, "latency_s": dt,
                             "tokens_per_s": ntok / dt})
            log(f"[serve] {path} {len(batch)} seq, {ntok} tokens: "
                f"{dt * 1e3:.1f} ms, {ntok / dt:,.0f} tokens/s")
            if path == "/logits" and len(batch) == 2:
                small = (batch, out)
        launches = ssd_batched.launches
        dispatches = svc.n_dispatches - d0
        peak = torch.cuda.max_memory_allocated()
        # the first /embed and /logits requests after the warm-up against
        # the same requests again, warmed by live ones, and the /logits
        # dispatch alone (no HTTP, JSON or batching thread)
        t0 = time.perf_counter()
        _post(server.port, "/embed", {"sequences": plan[0][1]})
        embed_again_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = _post(server.port, "/logits", {"sequences": small[0]})[
            "logits"]
        again_s = time.perf_counter() - t0
        check(again == small[1], "the repeated /logits request differs")
        ids = np.full((2, 1024), svc.tok.pad_token_id, np.int64)
        for i, q in enumerate(small[0]):
            ids[i, :len(q)] = svc.tok.encode(q)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc._dispatch("logits", ids, [len(q) for q in small[0]])
        dispatch_s = time.perf_counter() - t0
    finally:
        server.stop()
    first_s = requests[1]["latency_s"]
    log(f"[serve] first /logits request after the warm-up (bucket 1024, 2 "
        f"seq) {first_s * 1e3:.1f} ms, the same request again "
        f"{again_s * 1e3:.1f} ms (ratio {first_s / again_s:.3f}), its "
        f"dispatch alone {dispatch_s * 1e3:.1f} ms; the first /embed "
        f"{requests[0]['latency_s'] * 1e3:.1f} ms, again "
        f"{embed_again_s * 1e3:.1f} ms")
    per = 2 * cfg.n_layer
    log(f"[serve] ssd_fused_fwd launches {launches} over {dispatches} "
        f"dispatches (expect {per} each); peak memory "
        f"{peak / 2**30:.2f} GiB")
    check(dispatches == len(plan), f"{dispatches} dispatches for "
          f"{len(plan)} requests")
    check(launches == per * dispatches and launches > 0,
          f"kernel launches {launches} != {per} x {dispatches} dispatches")

    # the served logits are the model's own: rerun the 1024-bucket
    # dispatch directly (the server only pads and slices) ...
    batch, out = small
    tok = svc.tok
    ids = torch.full((2, 1024), tok.pad_token_id, dtype=torch.long)
    for i, s in enumerate(batch):
        ids[i, :len(s)] = torch.from_numpy(tok.encode(s).astype(np.int64))
    with torch.inference_mode():
        direct = svc.model(ids.cuda()).cpu().numpy()
    served = [np.asarray(o, np.float32) for o in out]
    for i, s in enumerate(batch):
        err = np.abs(served[i] - direct[i, :len(s)]).max()
        check(err <= 1e-6, f"served /logits differ from the model by {err}")
    # ... and agree with the fp32 model on the CPU (same weights): the
    # card computes in bf16 (8-bit mantissa) through 16 layers
    ref_model = CaduceusForMaskedLM(
        dataclasses.replace(cfg, dtype="float32"), device="cpu")
    ref_model.load_state_dict({k: v.cpu() for k, v in
                               svc.model.state_dict().items()})
    with torch.inference_mode():
        ref = ref_model(ids).numpy()
    err = max(np.abs(served[i] - ref[i, :len(s)]).max()
              for i, s in enumerate(batch))
    scale = max(np.abs(ref[i, :len(s)]).max() for i, s in enumerate(batch))
    diff = np.concatenate([(served[i] - ref[i, :len(s)]).ravel()
                           for i, s in enumerate(batch)])
    want = np.concatenate([ref[i, :len(s)].ravel()
                           for i, s in enumerate(batch)])
    rel_l2 = float(np.linalg.norm(diff) / np.linalg.norm(want))
    log(f"[serve] bf16 /logits on the card vs fp32 on the CPU (16 layers, "
        f"L=1024): max err {err:.3e}, max|logit| {scale:.3e} "
        f"(tol {BF16_MODEL_TOL} normalized), rel_l2 {rel_l2:.2e}")
    check(err <= BF16_MODEL_TOL * scale,
          f"served bf16 logits vs fp32 CPU: {err:.3e} > {BF16_MODEL_TOL} x "
          f"{scale:.3e}")
    # the 131k request without HTTP/JSON: one direct forward
    long_ids = torch.from_numpy(
        svc.tok.encode(plan[-1][1][0]).astype(np.int64))[None].cuda()
    with torch.inference_mode():
        svc.model(long_ids)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc.model(long_ids)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
    log(f"[serve] direct forward, 1 x 131072 tokens (no HTTP/JSON): "
        f"{fwd_s * 1e3:.1f} ms")
    return {"requests": requests, "launches": launches,
            "dispatches": dispatches, "peak_mem_bytes": peak,
            "warmup": {"programs": n_warm, "s": warm_s,
                       "launches": warm_launches,
                       "first_logits_s": first_s, "again_s": again_s,
                       "dispatch_s": dispatch_s,
                       "first_embed_s": requests[0]["latency_s"],
                       "embed_again_s": embed_again_s},
            "forward_131k_s": fwd_s,
            "bf16_vs_fp32_cpu": {"max_abs_err": float(err),
                                 "max_abs_ref": float(scale),
                                 "rel_l2": rel_l2}}


def _counts():
    from caduceus_tpu_torch.ops import scan, ssd_head
    from caduceus_tpu_torch.ops import ssd_batched as sb

    return {"ssd_fused_fwd": sb.launches, "ssd_fwd": sb.unfused_launches,
            "ssd_fused_bwd_kernel":
            sb.bwd_launches, "ssd_conv_bwd_kernel": sb.conv_bwd_launches,
            "ssd_bwd": sb.unfused_bwd_launches,
            "ssd_head_fwd": ssd_head.head_fwd_launches,
            "ssd_head_bwd": ssd_head.head_bwd_launches,
            "selective_scan_fwd": scan.fwd_launches,
            "bidir_scan_fwd": scan.bidir_launches,
            "selective_scan_bwd": scan.bwd_launches,
            "bidir_scan_bwd": scan.bidir_bwd_launches,
            "ssd_fused_cp": sb.cp_launches,
            "ssd_fused_bwd_kernel_cp": sb.cp_bwd_launches,
            "ssd_conv_bwd_kernel_cp": sb.cp_conv_bwd_launches}


def _zero_counts():
    from caduceus_tpu_torch.ops import scan, ssd_head
    from caduceus_tpu_torch.ops import ssd_batched as sb

    sb.launches = sb.unfused_launches = 0
    sb.bwd_launches = sb.conv_bwd_launches = sb.unfused_bwd_launches = 0
    ssd_head.head_fwd_launches = ssd_head.head_bwd_launches = 0
    scan.fwd_launches = scan.bidir_launches = scan.bwd_launches = 0
    scan.bidir_bwd_launches = 0
    sb.cp_launches = sb.cp_bwd_launches = sb.cp_conv_bwd_launches = 0


def _per_head(cfg) -> bool:
    """Whether the v2 config takes the per-head route (`models/mamba2.py`)."""
    k = cfg.ssm_cfg.use_kernel
    return k.startswith("pallas") and not k.startswith("pallas_batched")


def _per_micro_batch(cfg):
    """Launches of one micro-batch's forward + backward with remat span 1:
    each layer's forward runs twice (the remat recompute), its backward
    once. v2: two SSD directions per layer (fused-conv kernels, or the
    per-head pair for ``use_kernel="pallas"``); v1 bidirectional: one
    paired forward and two backward launches per layer (one paired backward
    with CADUCEUS_BIDIR_BWD=1); v1 unidirectional: one and one."""
    n = cfg.n_layer
    out = dict.fromkeys(_counts(), 0)
    if cfg.ssm_cfg.version == 2 and _per_head(cfg):
        out.update({"ssd_head_fwd": 2 * n * 2, "ssd_head_bwd": 2 * n})
    elif cfg.ssm_cfg.version == 2:
        out.update({"ssd_fused_fwd": 2 * n * 2, "ssd_fused_bwd_kernel": 2 * n,
                    "ssd_conv_bwd_kernel": 2 * n})
    elif cfg.bidirectional and os.environ.get("CADUCEUS_BIDIR_BWD") == "1":
        out.update({"bidir_scan_fwd": n * 2, "bidir_scan_bwd": n})
    elif cfg.bidirectional:
        out.update({"bidir_scan_fwd": n * 2, "selective_scan_bwd": 2 * n})
    else:
        out.update({"selective_scan_fwd": n * 2, "selective_scan_bwd": n})
    return out


def phase_train_vs_cpu(config=None, n_layer=2):
    """One step (accum 2) of the full-width model at ``n_layer`` layers,
    L=2048, fp32, on the card and on the CPU from the same weights and
    batch."""
    from caduceus_tpu_torch.models.caduceus import CaduceusForMaskedLM
    from caduceus_tpu_torch.train.optim import (make_optimizer,
                                                weight_decay_mask)
    from caduceus_tpu_torch.train.trainer import TrainState, make_train_step

    config = config or hg38_mlm_v2_config
    cfg = config(n_layer=n_layer, dtype="float32")
    L, accum = 2048, 2
    cpu = CaduceusForMaskedLM(cfg, device="cpu",
                              generator=torch.Generator().manual_seed(4321))
    card = CaduceusForMaskedLM(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(4322)
    ids = torch.randint(7, 11, (accum, L), generator=gen)
    tgt = torch.randint(0, 12, (accum, L), generator=gen)
    # warmup_t=0: step 0 runs at the full lr, so the update is not tiny
    opt_kw = dict(lr=8e-3, warmup_t=0, t_initial=50_000, weight_decay=0.1)
    p0 = {n: p.detach().double() for n, p in cpu.named_parameters()}
    out = {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("card", card, "cuda")):
        opt, schedule = make_optimizer(model.named_parameters(), **opt_kw)
        state = TrainState(model, opt)
        step = make_train_step(accum_steps=accum)
        _zero_counts()
        t0 = time.perf_counter()
        state, m = step(state, {"input_ids": ids.to(dev),
                                "targets": tgt.to(dev)})
        if dev == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        m = {k: float(v) for k, v in m.items()}
        # .grad holds the clipped gradient the update was made from
        out[name] = (m, {n: p.grad.detach().cpu()
                         for n, p in model.named_parameters()},
                     {n: p.detach().cpu() for n, p in
                      model.named_parameters()}, secs, _counts())
    (m_c, g_c, p_c, s_c, _), (m_k, g_k, p_k, s_k, counts) = (out["cpu"],
                                                             out["card"])
    want = {k: v * accum for k, v in _per_micro_batch(cfg).items()}
    check(counts == want, f"train step launches {counts} != {want}")
    for k in ("loss", "grad_norm"):
        check(math.isfinite(m_k[k]), f"card {k} not finite")
        rel = abs(m_k[k] - m_c[k]) / abs(m_c[k])
        check(rel <= TRAIN_TOL["metric"], f"card vs CPU {k}: {m_k[k]} vs "
              f"{m_c[k]} (rel {rel:.2e})")
    # the first AdamW update, in fp64 from the card's own clipped gradient:
    # p·(1 - lr·wd) - lr·g / (|g| + eps) (m̂ = g, √v̂ = |g| at step 1)
    lr, decay = schedule(0), weight_decay_mask(card.named_parameters())
    g_err = p_err = adam_err = 0.0
    worst, unsettled = "", {}
    for n in g_c:
        # the mean gradients before clipping, against the CPU's largest
        gc = g_c[n] * max(1.0, m_c["grad_norm"])
        gk = g_k[n] * max(1.0, m_k["grad_norm"])
        s = gc.abs().max().item() + 1e-30
        e = ((gk - gc).abs().max() / s).item()
        if e > g_err:
            g_err, worst = e, n
        scale = 1 + p0[n].abs()
        g = g_k[n].double()
        ref = (p0[n] * (1 - lr * opt_kw["weight_decay"] * decay[n])
               - lr * g / (g.abs() + 1e-8))
        a = ((p_k[n].double() - ref).abs() / scale).max().item()
        check(a <= TRAIN_TOL["param"], f"card's update of {n} vs AdamW from "
              f"its own gradient: {a:.2e}·(1+|p|)")
        adam_err = max(adam_err, a)
        # card vs CPU: strict where the gradient is well above 0; near 0
        # the sign of g decides Adam's first step, so there 2·lr
        settled = ((gc.abs() > TRAIN_TOL["settled"] * s)
                   & (gc.abs() > TRAIN_TOL["adam_floor"]))
        unsettled[n] = (int((~settled).sum()), settled.numel())
        d = (p_k[n] - p_c[n]).abs()
        lim = torch.where(settled, TRAIN_TOL["param"] * scale.float(),
                          torch.full_like(d, 2 * lr))
        check(bool((d <= lim).all()), f"card vs CPU updated {n}: max "
              f"|diff| {d.max().item():.3e}")
        p_err = max(p_err, ((d / scale) * settled).max().item())
    check(g_err <= TRAIN_TOL["grad"], f"card vs CPU gradient {worst}: "
          f"{g_err:.2e} of its max > {TRAIN_TOL['grad']}")
    most = max(unsettled, key=lambda n: unsettled[n][0] / unsettled[n][1])
    log(f"[train] {config.__name__[:-7]}: card vs CPU, full width, "
        f"{n_layer} layers, "
        f"L=2048, fp32, accum 2: "
        f"loss {m_k['loss']:.6f} vs {m_c['loss']:.6f}, grad_norm "
        f"{m_k['grad_norm']:.6f} vs {m_c['grad_norm']:.6f}; worst gradient "
        f"{worst} {g_err:.2e} of its max (tol {TRAIN_TOL['grad']}); worst "
        f"updated parameter {p_err:.2e}·(1+|p|) where |g| > "
        f"{TRAIN_TOL['settled']}·max|g| and {TRAIN_TOL['adam_floor']} (tol "
        f"{TRAIN_TOL['param']}); held "
        f"only to 2·lr against the CPU: "
        f"{sum(u for u, _ in unsettled.values())} of "
        f"{sum(t for _, t in unsettled.values())} elements, at most "
        f"{unsettled[most][0]} of {unsettled[most][1]} in one leaf ({most}); "
        f"every element's update vs AdamW from the card's own gradient: "
        f"{adam_err:.2e}·(1+|p|) (tol {TRAIN_TOL['param']}); launches "
        f"{counts}; card step {s_k:.2f} s, CPU step {s_c:.2f} s")
    return {"loss": [m_k["loss"], m_c["loss"]],
            "grad_norm": [m_k["grad_norm"], m_c["grad_norm"]],
            "grad_err": g_err, "param_err": p_err, "adam_err": adam_err,
            "unsettled_share": unsettled, "launches": counts,
            "card_s": s_k, "cpu_s": s_c}


def phase_train_full(config=None, n_layer=16):
    """`make_train_step` + `make_optimizer` on a full-width model (default
    hg38_mlm_v2; hg38_mlm for v1) at L=131072, micro-batches of 2
    sequences (G=4 per scan call), accum 2; one warm-up and 2 timed
    steps."""
    from caduceus_tpu_torch.models.caduceus import CaduceusForMaskedLM
    from caduceus_tpu_torch.train.optim import make_optimizer
    from caduceus_tpu_torch.train.trainer import TrainState, make_train_step

    config = config or hg38_mlm_v2_config
    cfg = config(n_layer=n_layer)
    L, micro, accum, n_steps = 131072, 2, 2, 3
    model = CaduceusForMaskedLM(cfg, device="cuda",
                                generator=torch.Generator().manual_seed(2222))
    opt, _ = make_optimizer(model.named_parameters(), lr=8e-3, warmup_t=100,
                            t_initial=50_000)
    state = TrainState(model, opt)
    step = make_train_step(accum_steps=accum)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batches = [{"input_ids": torch.randint(7, 11, (micro * accum, L),
                                           generator=gen, device="cuda"),
                "targets": torch.randint(0, 12, (micro * accum, L),
                                         generator=gen, device="cuda")}
               for _ in range(n_steps)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    steps = []
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        m = {k: float(v) for k, v in m.items()}
        steps.append({"step_s": secs, **m})
        log(f"[train] {config.__name__[:-7]} full width, {n_layer} layers, "
            f"L={L}, {micro} x {accum} "
            f"sequences: step {i} ({'warm-up' if i == 0 else 'timed'}) "
            f"{secs:.2f} s, loss {m['loss']:.5f}, grad_norm "
            f"{m['grad_norm']:.4f}, acc {m['acc']:.4f}")
        check(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]),
              f"step {i}: loss {m['loss']}, grad_norm {m['grad_norm']}")
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    n_mb = n_steps * accum
    want = {k: v * n_mb for k, v in _per_micro_batch(cfg).items()}
    check(counts == want, f"training launches {counts} != {want} "
          f"({n_mb} micro-batches)")
    timed = [s["step_s"] for s in steps[1:]]
    step_s = float(np.mean(timed))
    tokens = micro * accum * L
    log(f"[train] timed steps {', '.join(f'{t:.2f}' for t in timed)} s: "
        f"{step_s:.2f} s/step, {tokens / step_s:,.0f} tokens/s; peak device "
        f"memory {peak / 2**30:.2f} GiB; launches {counts} over {n_mb} "
        f"micro-batches (= {_per_micro_batch(cfg)} each)")
    del model, state, opt, batches
    torch.cuda.empty_cache()
    return {"n_layer": n_layer, "steps": steps, "step_s": step_s,
            "tokens_per_step": tokens,
            "tokens_per_s": tokens / step_s, "peak_mem_bytes": peak,
            "launches": counts, "micro_batches": n_mb, "accum": accum}


def _time_cuda(fn, n):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _bound(nbytes, flops, flop_per_s=BF16_FLOP_PER_S):
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / flop_per_s * 1e3
    return {"bytes": nbytes, "flops": flops,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def _ssd_bounds(G, L, H, P, NG, N, K, T):
    """Bounds of #1 (with carries), #3a and #3b at (G, L), bf16: each input
    read once and each output written once (bf16 rows, fp32 parameters and
    hN, bf16 carries); the matmul work the function needs (no per-head
    recompute of CB): CB per group, M@dx, C@h, B^T@wdx in the forward; CB,
    LG@B, LG^T@C once per group, G, gdx (T x T x P) and six N x P products
    per head in the adjoint, which takes the reads of xBC, dt, g_y and the
    carries and the write of g_dt; #3b the write of g_xBC and its
    elementwise fp32 work (~6K + 8 operations per element)."""
    rows, Wc, nc = G * L, H * P + 2 * NG * N, -(-L // T)
    car_bytes = G * nc * H * N * P * 2
    return {
        "ssd_fused_fwd": _bound(
            rows * (Wc + H) * 2 + rows * H * P * 2 + G * H * N * P * 4
            + car_bytes,
            rows * (2 * T * N * NG + 2 * T * P * H + 4 * N * P * H)),
        "ssd_fused_bwd_kernel": _bound(
            rows * (Wc * 2 + H * 2 + H * P * 2 + H * 2) + car_bytes,
            rows * (6 * T * N * NG + H * (4 * T * P + 12 * N * P))),
        "ssd_conv_bwd_kernel": _bound(rows * Wc * 2, rows * Wc * (6 * K + 8),
                                      FP32_FLOP_PER_S)}


def _scan_bounds(G, L, d, N, T):
    """Bounds of #9 (both directions, carries saved) and #8 at (G, L),
    bf16: per row and direction u and delta read, B and C read, y written;
    the adjoint reads u, delta, g_y, B, C and the carries and writes g_u,
    g_delta, g_B, g_C; fp32 FLOP on the non-tensor-core units."""
    rows, nc = G * L, -(-L // T)
    car_bytes = G * nc * d * N * 4
    io_fwd = rows * (2 * d * 2 + 2 * N * 2 + d * 2)
    return {
        "bidir_scan_fwd": _bound(2 * (io_fwd + car_bytes),
                                 2 * 5 * rows * d * N, FP32_FLOP_PER_S),
        "selective_scan_bwd": _bound(
            rows * (3 * d * 2 + 2 * N * 2 + 2 * d * 2 + 2 * N * 2)
            + car_bytes, 20 * rows * d * N, FP32_FLOP_PER_S)}


def _timed(kernel_fn, plain_fn, n_kernel=3):
    """Kernel and plain version in turns (plain, kernel, kernel, plain)."""
    plain_ms = [_time_cuda(plain_fn, 1)]
    kernel_ms = [_time_cuda(kernel_fn, n_kernel), _time_cuda(kernel_fn,
                                                             n_kernel)]
    plain_ms.append(_time_cuda(plain_fn, 1))
    return {"ms": float(np.mean(kernel_ms)), "kernel_ms_runs": kernel_ms,
            "plain_ms": float(np.mean(plain_ms)), "plain_ms_runs": plain_ms}


def _sub_launches(call, parts, bytes_of, n=3):
    """Each sub-launch of one kernel call timed alone (``call(parts, ws)``
    runs the chosen ones with the workspace of a full call made first, so
    every input a sub-launch reads is in place), beside the bytes it must
    move and their time at the card's memory rate."""
    ws = call(sum(parts.values()), None)
    out = {}
    for name, part in parts.items():
        ms = _time_cuda(lambda: call(part, ws), n)
        nbytes = bytes_of[name]
        out[name] = {"ms": ms, "bytes": nbytes,
                     "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    log("[time]   sub-launches: " + "; ".join(
        f"{k} {v['ms']:.3f} ms ({v['bytes'] / 1e9:.3f} GB, "
        f"{v['bytes_ms']:.3f} ms at {HBM_BYTES_PER_S / 1e12:.2f} TB/s)"
        for k, v in out.items()))
    return out


def phase_timing():
    """The forward kernel at the serving batch (G=16: 8 sequences x 2
    strands, L=131072, bf16, no carries) and every kernel at the training
    shape (G=4, L=131072, bf16, forward direction), each beside its plain
    version and its bound; the timed outputs held against the plain
    versions'."""
    from caduceus_tpu_torch.kernel_check import TOL
    from caduceus_tpu_torch.ops import ssd as plain
    from caduceus_tpu_torch.ops import ssd_batched as sb
    from caduceus_tpu_torch.ops.ssd_batched import (
        KERNEL_CHUNK, conv_silu_bwd, ssd_adjoint_xc, ssd_batched_fused,
        ssd_fused_fwd)

    L, H, P, NG, N, K = 131072, 8, 64, 1, 128, 4
    T = KERNEL_CHUNK[torch.bfloat16]
    Wc = H * P + 2 * NG * N
    bf16 = TOL[torch.bfloat16]
    res = {}

    # -- forward, serving batch G=16, no carries
    G = 16
    inp = ssd_inputs(G, L, H, P, NG, N, K, torch.bfloat16, 99, width_pad=512)
    args = (inp["xBC"], inp["dt"], inp["A"], inp["conv_w"])
    kw = dict(conv_b=inp["conv_b"], D=inp["D"], dt_bias=inp["dt_bias"],
              dims=inp["dims"], dt_softplus=True, return_final_state=True)
    outs = {}
    t = _timed(lambda: outs.__setitem__("k", ssd_batched_fused(*args, **kw)),
               lambda: outs.__setitem__("p", plain.ssd_chunked_fused(
                   *args, chunk_size=T, **kw)), n_kernel=5)
    one = (inp["xBC"][:2], inp["dt"][:2]) + args[2:]
    t["ms_G2"] = _time_cuda(lambda: outs.__setitem__(
        "k2", ssd_batched_fused(*one, **kw)), 3)
    y_p, h_p = outs.pop("p")
    t["checks"] = {
        "G=16": hold(f"timed fwd G=16 L={L} bf16", bf16, outs.pop("k"),
                     (y_p, h_p), ("y", "hN")),
        "G=2": hold(f"timed fwd G=2 L={L} bf16 (one 131k request)", bf16,
                    outs.pop("k2"), (y_p[:2], h_p[:2]), ("y", "hN"))}
    rows = G * L
    # each input read once, each output written once (bf16 = 2 bytes); the
    # fp32 parameters and hN are < 1 MB. Matmul work the function needs
    # (no per-head recompute of CB): CB per group, M@dx, C@h, B^T@wdx
    t.update(_bound(rows * (Wc + H) * 2 + rows * H * P * 2
                    + G * H * N * P * 4,
                    rows * (2 * T * N * NG + 2 * T * P * H + 4 * N * P * H)))
    res["fwd_G16"] = t
    log(f"[time] ssd_fused_fwd G=16 L={L} bf16: kernel {t['ms']:.3f} ms "
        f"(runs {', '.join(f'{v:.3f}' for v in t['kernel_ms_runs'])}), "
        f"plain {t['plain_ms']:.1f} ms, bound {t['bound_ms']:.3f} ms "
        f"({t['bound_by']}); at G=2 (one 131k request) {t['ms_G2']:.3f} ms")
    del inp, args, one, y_p, h_p, outs

    # -- the training shape: G=4 (2 sequences x 2 strands)
    G = 4
    rows = G * L
    nc = -(-L // T)
    inp = ssd_inputs(G, L, H, P, NG, N, K, torch.bfloat16, 98, width_pad=512)
    a7 = (inp["xBC"], inp["dt"], inp["A"], inp["conv_w"], inp["conv_b"],
          inp["D"], inp["dt_bias"])
    outs = {}
    t = _timed(lambda: outs.__setitem__("k", ssd_fused_fwd(
                   *a7, inp["dims"], True, False, T, None, save_carries=True)),
               lambda: outs.__setitem__("p", plain.ssd_chunked_fused(
                   *a7, dims=inp["dims"], dt_softplus=True, chunk_size=T,
                   return_carries=True)))
    fwd_k, fwd_p = outs.pop("k"), outs.pop("p")
    t["check"] = hold(f"timed fwd + carries G=4 L={L} bf16", bf16, fwd_k,
                      fwd_p)
    car_bytes = G * nc * H * N * P * 2
    bounds = _ssd_bounds(G, L, H, P, NG, N, K, T)
    t.update(bounds["ssd_fused_fwd"])
    res["fwd_G4_carries"] = t
    log(f"[time] ssd_fused_fwd + carries G=4 L={L} bf16: kernel "
        f"{t['ms']:.3f} ms, plain {t['plain_ms']:.1f} ms, bound "
        f"{t['bound_ms']:.3f} ms ({t['bound_by']}: {t['bytes'] / 1e9:.2f} GB)")
    # the three launches of one call: bytes each must move (bf16 rows; the
    # pre-pass reads x, dt and B for the S - 1 segments it covers; the main
    # pass reads x, dt, B, C and CB and writes y and the carries)
    S = sb.n_segments(G, H, nc, "cuda")
    frac = (S - 1) / S
    cb_bytes = G * NG * nc * T * T * 4
    t["segments"] = S
    t["sub_launches"] = _sub_launches(
        lambda parts, ws: sb.fused_fwd_call(
            *a7, inp["dims"], True, False, T, None, True, parts=parts,
            ws=ws)[3],
        {"prep": sb.PART_PREP, "pre-pass": sb.PART_STATE,
         "main pass": sb.PART_MAIN},
        {"prep": rows * 2 * NG * N * 2 * 2 + cb_bytes,
         "pre-pass": frac * rows * (H * P + H + NG * N) * 2
         + G * H * (S - 1) * N * P * 4,
         "main pass": rows * (H * P + H + 2 * NG * N) * 2 + cb_bytes
         + rows * H * P * 2 + car_bytes + G * H * N * P * 4})
    car = fwd_k[2]
    del fwd_k, fwd_p
    bwd_args = a7 + (inp["g_y"], car, None, inp["dims"], True, False, T)

    t = _timed(lambda: outs.__setitem__("k", ssd_adjoint_xc(*bwd_args)),
               lambda: outs.__setitem__("p", plain.ssd_adjoint_xc(*bwd_args)))
    adj_k, adj_p = outs.pop("k"), outs.pop("p")
    t["check"] = hold(
        f"timed ssd_fused_bwd_kernel G=4 L={L} bf16", TOL[torch.bfloat16],
        adj_k, adj_p, ("g_xc", "g_dt", "g_A", "g_D", "g_dt_bias", "g_h0"),
        tag="bwd")
    # The two kernels' bounds split the backward function's own bound
    # (each input read once, each output written once): this kernel takes
    # the reads of xBC, dt, g_y and the carries and the write of g_dt, and
    # all the matmul work: CB, LG@B, LG^T@C once per group, G, gdx
    # (T x T x P) and six N x P products (B@lambda, C@h, B^T@wdx, gye@h^T,
    # wdx@lambda^T, C^T@gye) per head. The fp32 (G, L, Wc) workspace
    # between the two kernels is a cost of the split design, not of the
    # function: it stands beside the bound as `extra_bytes`.
    t.update(bounds["ssd_fused_bwd_kernel"])
    t["extra_bytes"] = rows * Wc * 4
    # the four launches of one call: the pre-pass reads C, dt and g_y for
    # S - 1 segments; the main pass reads x, dt, B, C, CB, g_y and the
    # carries and writes g_x (fp32 workspace columns), g_dt and the heads'
    # fp32 g_B / g_C shares; the share sum reads those and writes g_B, g_C
    t["segments"] = S
    share_bytes = rows * H * 2 * N * 4
    t["sub_launches"] = _sub_launches(
        lambda parts, ws: sb.adjoint_xc_call(*bwd_args, parts=parts,
                                             ws=ws)[1],
        {"prep": sb.PART_PREP, "pre-pass": sb.PART_STATE,
         "main pass": sb.PART_MAIN, "share sum": sb.PART_SUM},
        {"prep": rows * 2 * NG * N * 2 * 2 + cb_bytes,
         "pre-pass": frac * rows * (NG * N + H + H * P) * 2
         + G * H * (S - 1) * N * P * 4,
         "main pass": rows * (H * P + H + 2 * NG * N + H * P) * 2 + cb_bytes
         + car_bytes + rows * (H * P * 4 + H * 2) + share_bytes,
         "share sum": share_bytes + rows * 2 * NG * N * 4})
    res["bwd_main"] = t
    log(f"[time] ssd_fused_bwd_kernel G=4 L={L} bf16: kernel {t['ms']:.3f} "
        f"ms, plain {t['plain_ms']:.1f} ms, bound {t['bound_ms']:.3f} ms "
        f"({t['bound_by']}: {t['bytes'] / 1e9:.2f} GB, "
        f"{t['flops'] / 1e12:.2f} TFLOP; workspace write "
        f"{t['extra_bytes'] / 1e9:.2f} GB on top)")

    g_xc = adj_k[0]
    conv_args = (g_xc, inp["xBC"], inp["conv_w"], inp["conv_b"], False)
    t = _timed(lambda: outs.__setitem__("k", conv_silu_bwd(*conv_args)),
               lambda: outs.__setitem__("p", plain.conv_silu_bwd(*conv_args)),
               n_kernel=10)
    conv_k, conv_p = outs.pop("k"), outs.pop("p")
    t["check"] = hold(
        f"timed ssd_conv_bwd_kernel G=4 L={L} bf16 (the kernel's g_xc)",
        TOL[torch.bfloat16], conv_k, conv_p,
        ("g_xBC", "g_conv_w", "g_conv_b"), tag="bwd")
    # its share of the function's bound: the write of g_xBC, and the
    # elementwise fp32 work (conv recompute, SiLU adjoint, conv transpose,
    # g_w / g_b: ~6K + 8 operations per element) on the non-tensor-core
    # fp32 units; on top, the split design reads the workspace and xBC a
    # second time
    t.update(bounds["ssd_conv_bwd_kernel"])
    t["extra_bytes"] = rows * Wc * (4 + 2)
    # the kernel alone as a function of its own inputs: g_xc and xBC read
    # once, g_xBC written once
    t["floor"] = _bound(rows * Wc * (4 + 2 + 2), rows * Wc * (6 * K + 8),
                        FP32_FLOP_PER_S)
    t["library_pair"] = library_pair_timing(conv_args, conv_p)
    res["bwd_conv"] = t
    log(f"[time] ssd_conv_bwd_kernel G=4 L={L} bf16: kernel {t['ms']:.3f} "
        f"ms (runs {', '.join(f'{v:.3f}' for v in t['kernel_ms_runs'])}), "
        f"plain {t['plain_ms']:.1f} ms, bound {t['bound_ms']:.3f} ms "
        f"({t['bound_by']}; workspace and xBC reads "
        f"{t['extra_bytes'] / 1e9:.2f} GB on top); floor of the kernel's own "
        f"traffic {t['floor']['bound_ms']:.3f} ms "
        f"({t['floor']['bytes'] / 1e9:.2f} GB); two PyTorch calls "
        f"{t['library_pair']['ms']:.3f} ms")
    # the whole backward against the plain version end to end
    whole_p = plain.conv_silu_bwd(adj_p[0], inp["xBC"], inp["conv_w"],
                                  inp["conv_b"], False)
    pick = lambda c, a: (c[0], a[1], a[2], c[1], c[2], a[3], a[4], a[5])
    res["bwd_whole"] = hold(f"timed ssd_fused_bwd (both kernels) G=4 L={L}",
                            TOL[torch.bfloat16], pick(conv_k, adj_k),
                            pick(whole_p, adj_p), BWD_NAMES, tag="bwd")
    # the function's own bound: reads xBC, dt, g_y, carries; writes g_xBC,
    # g_dt; and the pair's time against it
    res["bwd_function_bound"] = _bound(
        rows * (Wc * 2 + H * 2 + H * P * 2 + Wc * 2 + H * 2) + car_bytes,
        rows * (6 * T * N * NG + H * (4 * T * P + 12 * N * P)))
    pair_ms = res["bwd_main"]["ms"] + res["bwd_conv"]["ms"]
    log(f"[time] ssd_fused_bwd, both kernels: {pair_ms:.3f} ms, bound of "
        f"the function {res['bwd_function_bound']['bound_ms']:.3f} ms "
        f"({res['bwd_function_bound']['bytes'] / 1e9:.2f} GB), sum of the "
        f"kernels' bounds {res['bwd_main']['bound_ms'] + res['bwd_conv']['bound_ms']:.3f} ms")
    return res


def library_pair(g_xc, xBC, conv_w, conv_b):
    """The pair of PyTorch calls that computes #3b's function (forward
    direction), a yardstick the port never calls: ``torch.ops.aten.
    silu_backward`` then ``convolution_backward`` of the depthwise causal
    conv (groups = Wc) on channel-first views. Set-up, not timed: xBC in
    fp32 with K-1 zero rows in front (the conv's causal padding), and
    pre = conv(xBC) by `conv1d`. Returns (call, to_outputs): ``call()``
    runs the two calls; ``to_outputs`` maps its result to (g_xBC,
    g_conv_w, g_conv_b) in the port's layouts."""
    G, L, Wc = xBC.shape
    K = conv_w.shape[0]
    x_cf = torch.nn.functional.pad(xBC.float().transpose(1, 2), (K - 1, 0))
    weight = conv_w.float().t().reshape(Wc, 1, K).contiguous()
    pre = torch.nn.functional.conv1d(x_cf, weight, conv_b.float(), groups=Wc)
    g_cf = g_xc.transpose(1, 2)

    def call():
        g_pre = torch.ops.aten.silu_backward(g_cf, pre)
        return torch.ops.aten.convolution_backward(
            g_pre, x_cf, weight, [Wc], [1], [0], [1], False, [0], Wc,
            [True, True, True])

    def to_outputs(res):
        g_x, g_w, g_b = res
        return (g_x[..., K - 1:].transpose(1, 2).to(xBC.dtype),
                g_w.reshape(Wc, K).t(), g_b)

    return call, to_outputs


def library_pair_timing(conv_args, conv_p):
    """The two PyTorch calls of `library_pair` timed on #3b's inputs (the
    set-up outside the timing), after holding their outputs to the plain
    version's (the bf16 rule), so the yardstick computes the same
    function."""
    from caduceus_tpu_torch.kernel_check import TOL

    g_xc, xBC, conv_w, conv_b, _ = conv_args
    call, to_outputs = library_pair(g_xc, xBC, conv_w, conv_b)
    out = {"check": hold("library pair (silu_backward + convolution_backward)"
                         " vs plain", TOL[torch.bfloat16],
                         to_outputs(call()), conv_p, CONV_NAMES, tag="conv")}
    call()
    out["ms_runs"] = [_time_cuda(call, 3), _time_cuda(call, 3)]
    out["ms"] = float(np.mean(out["ms_runs"]))
    del call, to_outputs
    torch.cuda.empty_cache()
    return out


def phase_determinism():
    """Run-to-run bits at the training shape (G=4, L=131072, bf16, forward
    direction): the fused forward with carries (#1) and the fused backward
    (#3: the SSD adjoint and the conv adjoint), the unfused forward and
    adjoint (#2 / #4), and the v1 scan pairs of `scan_determinism_pairs`,
    each twice on the same inputs; every output must be bit for bit the
    same (no sum is left to atomics)."""
    from caduceus_tpu_torch.ops import ssd_batched as sb

    G, L, H, P, NG, N, K = 4, 131072, 8, 64, 1, 128, 4
    T = sb.KERNEL_CHUNK[torch.bfloat16]
    inp = ssd_inputs(G, L, H, P, NG, N, K, torch.bfloat16, 97, width_pad=512)
    a7 = (inp["xBC"], inp["dt"], inp["A"], inp["conv_w"], inp["conv_b"],
          inp["D"], inp["dt_bias"])
    runs = {}

    def fused():
        y, hN, car = sb.ssd_fused_fwd(*a7, inp["dims"], True, False, T,
                                      inp["h_init"], save_carries=True)
        g = sb.ssd_fused_bwd(*a7, inp["g_y"], car, inp["g_hN"], inp["dims"],
                             True, False, T)
        return dict(zip(FWD_NAMES + BWD_NAMES, (y, hN, car) + tuple(g)))

    uinp = unfused_inputs(G, L, H, P, NG, N, torch.bfloat16, 96, pad=16)
    ua = _unfused_args(uinp)

    def unfused():
        y, hN, car = sb.ssd_fwd(*ua, True, False, T, uinp["h_init"], True)
        g = sb.ssd_bwd(*ua, uinp["g_y"], car, uinp["g_hN"], True, False, T)
        return dict(zip(FWD_NAMES + UNFUSED_BWD_NAMES, (y, hN, car) + g))

    res = {}
    pairs = [("fused #1 + #3", fused), ("unfused #2 + #4", unfused)]
    for name, fn in pairs + scan_determinism_pairs():
        first = {k: v.clone() for k, v in fn().items()}
        second = fn()
        torch.cuda.synchronize()
        same = {k: bool(torch.equal(first[k], second[k])) for k in first}
        res[name] = same
        log(f"[determinism] {name}, G={G} L={L} bf16, two runs: " + ", ".join(
            f"{k} {'bit-equal' if v else 'DIFFER'}" for k, v in same.items()))
        check(all(same.values()), f"{name}: outputs differ between two runs "
              f"on the same inputs: {[k for k, v in same.items() if not v]}")
        del first, second
    del inp, uinp, pairs
    torch.cuda.empty_cache()
    return res


def scan_determinism_pairs():
    """The v1 scan kernels at the training shape (G=4, L=131072, d=512,
    N=16, bf16) for `phase_determinism`: #9 + #8 (both directions, #8 once
    per set), #7 + #8 with h_init and g_hN, and #10 from #9's carries."""
    from caduceus_tpu_torch.ops import scan

    G, L, d, N = 4, 131072, 512, 16
    T = scan.KERNEL_CHUNK
    f = scan_inputs(G, L, d, N, torch.bfloat16, 95, model_like=True)
    r = scan_inputs(G, L, d, N, torch.bfloat16, 94, model_like=True)
    a, b = _scan_args(f), _scan_args(r)
    pa = (*a[:2], *a[3:5], *b[:2], *b[3:5], a[2], b[2], a[5], b[5], a[6],
          b[6])

    def paired():
        yf, yr, cf, cr = scan.bidir_scan_fwd(*pa, save_carries=True)
        gf = scan.selective_scan_bwd_cuda(*a, f["g_y"], cf, None, True, False,
                                          T)
        gr = scan.selective_scan_bwd_cuda(*b, r["g_y"], cr, None, True, True,
                                          T)
        return dict(zip(("yf", "yr", "carf", "carr") + tuple(
            f"{n}f" for n in SCAN_BWD_NAMES[:7]) + tuple(
            f"{n}r" for n in SCAN_BWD_NAMES[:7]), (yf, yr, cf, cr) + gf[:7]
            + gr[:7]))

    def one_direction():
        y, hN, car = scan.selective_scan_fwd(*a, True, False, T, f["h0"],
                                             save_carries=True)
        g = scan.selective_scan_bwd_cuda(*a, f["g_y"], car, f["g_hN"], True,
                                         False, T)
        return dict(zip(SCAN_FWD_NAMES + SCAN_BWD_NAMES, (y, hN, car) + g))

    def paired_bwd():
        _, _, cf, cr = scan.bidir_scan_fwd(*pa, save_carries=True)
        g = scan.bidir_scan_bwd(*pa, f["g_y"], r["g_y"], cf, cr)
        return dict(zip(BIDIR_BWD_NAMES, g))

    return [("scan #9 + #8 (both directions)", paired),
            ("scan #7 + #8 (h_init, g_hN)", one_direction),
            ("scan #10", paired_bwd)]


# --- the v1 (Mamba-1) model: the selective scan kernels #7, #8, #9 -------

SCAN_FWD_NAMES = ("y", "hN", "carries")
SCAN_BWD_NAMES = ("g_u", "g_delta", "g_A", "g_B", "g_C", "g_D", "g_bias",
                  "g_h0")


def hg38_mlm_config(n_layer: int = 16, dtype: str = "bfloat16",
                    bidirectional: bool = True):
    """`configs/hg38_mlm.yaml`'s model (the v1 Caduceus-PS: d_model 256,
    d_inner 512, d_state 16, dt_rank 16), written out (no YAML)."""
    from caduceus_tpu_torch.config import CaduceusConfig, SSMConfig
    from caduceus_tpu_torch.tokenization import CaduceusTokenizer

    tok = CaduceusTokenizer()
    return CaduceusConfig(
        d_model=256, n_layer=n_layer, vocab_size=tok.vocab_size,
        rcps=bidirectional, complement_map=tok.complement_map
        if bidirectional else None, bidirectional=bidirectional,
        bidirectional_strategy="add", bidirectional_weight_tie=True,
        rms_norm=True, residual_in_fp32=False, fused_add_norm=True,
        dtype=dtype, param_dtype="float32", remat=True, remat_span=1,
        ssm_cfg=SSMConfig(version=1, d_state=16, d_conv=4, expand=2))


def scan_inputs(G, L, d, N, dtype, seed, model_like=False, D=True,
                bias=True):
    """Seeded scan operands on the card, with h_init and the cotangents.
    B and C are column slices of one (G, L, 16 + 2N) tensor, as the x_proj
    output gives them. ``model_like``: A = -(1..N) x exp(0.3 noise) and a
    dt bias of softplus^-1 of a log-uniform dt in [1e-3, 0.1], the model's
    init, so the states carry over thousands of rows."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    dbc = rnd(G, L, 16 + 2 * N).to(dtype)
    if model_like:
        A = -torch.arange(1, N + 1, device="cuda").float() * torch.exp(
            rnd(d, N, scale=0.3))
        dt = torch.exp(torch.rand(d, generator=g, device="cuda")
                       * math.log(100.0) + math.log(1e-3))
        b = dt + torch.log(-torch.expm1(-dt))
    else:
        A, b = -torch.exp(rnd(d, N, scale=0.5)), rnd(d, scale=0.1)
    return dict(u=rnd(G, L, d).to(dtype), delta=(rnd(G, L, d) * 0.5).to(dtype),
                A=A, B=dbc[..., 16:16 + N], C=dbc[..., 16 + N:],
                D=rnd(d) if D else None, bias=b if bias else None,
                h0=rnd(G, d, N), g_y=rnd(G, L, d).to(dtype),
                g_hN=rnd(G, d, N))


def _scan_args(inp, **over):
    k = {**inp, **over}
    return [k[n] for n in ("u", "delta", "A", "B", "C", "D", "bias")]


def scan_pair(inp, reverse, z=None, fault=(), **over):
    """`selective_scan_fwd` (with h_init and carries, gated by ``z`` when
    given) and its plain version on the same card tensors; ``over``
    replaces the kernel's inputs, ``fault`` names a planted fault's build
    (`scan_fault`)."""
    from caduceus_tpu_torch.ops import scan
    from caduceus_tpu_torch.ops.selective_scan import selective_scan

    T = scan.KERNEL_CHUNK
    with scan_fault(fault):
        kernel = scan.selective_scan_fwd(*_scan_args(inp, **over), True,
                                         reverse, T, inp["h0"],
                                         save_carries=True, z=z)
    torch.cuda.synchronize()
    plain = selective_scan(*_scan_args(inp), True, reverse, T, inp["h0"],
                           True, True, z=z)
    return kernel, plain


def gate_of(inp, seed):
    """A SiLU gate z for `scan_inputs`' u: the second half of a seeded
    (G, L, 2 d) tensor, as the in_proj output gives it (row stride 2 d)."""
    G, L, d = inp["u"].shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    xz = torch.randn(G, L, 2 * d, generator=g, device="cuda")
    return xz.to(inp["u"].dtype)[..., d:]


def bidir_pair(f, r, **over):
    """`bidir_scan_fwd` (set f left to right, set r right to left, with
    carries) and the two plain scans; ``over`` replaces the kernel's
    inputs of set r."""
    from caduceus_tpu_torch.ops import scan
    from caduceus_tpu_torch.ops.selective_scan import selective_scan

    T = scan.KERNEL_CHUNK
    a, b = _scan_args(f), _scan_args(r, **over)
    yf, yr, cf, cr = scan.bidir_scan_fwd(*a[:2], *a[3:5], *b[:2], *b[3:5],
                                         a[2], b[2], a[5], b[5], a[6], b[6],
                                         save_carries=True)
    torch.cuda.synchronize()
    pf = selective_scan(*_scan_args(f), True, False, T, return_carries=True)
    pr = selective_scan(*_scan_args(r), True, True, T, return_carries=True)
    return (yf, cf, yr, cr), pf + pr


def phase_scan_checks():
    """The forward kernels against the plain forward: small shapes (one
    partial chunk, and two chunks and a partial one), the SiLU(z) gate, the
    main geometry (d=512, N=16, G=4, L=8192), then planted faults."""
    from caduceus_tpu_torch.kernel_check import TOL

    res, seed = [], 200
    bidir_names = ("yf", "carf", "yr", "carr")
    for dtype in (torch.float32, torch.bfloat16):
        for L in (200, 600):
            for reverse in (False, True):
                for with_dd in (True, False):
                    seed += 1
                    inp = scan_inputs(2, L, 48, 16, dtype, seed, D=with_dd,
                                      bias=with_dd)
                    label = (f"scan fwd small G=2 L={L} d=48 N=16 "
                             f"{str(dtype)[6:]} rev={reverse} "
                             f"D,bias={with_dd}")
                    res.append({"case": label, **hold(
                        label, TOL[dtype], *scan_pair(inp, reverse),
                        SCAN_FWD_NAMES, tag="scan")})
            seed += 1
            inp = scan_inputs(2, L, 48, 16, dtype, seed)
            label = (f"scan fwd gated small G=2 L={L} d=48 N=16 "
                     f"{str(dtype)[6:]}")
            res.append({"case": label, **hold(
                label, TOL[dtype], *scan_pair(inp, L == 600,
                                              z=gate_of(inp, seed)),
                SCAN_FWD_NAMES, tag="scan")})
        seed += 1
        f = scan_inputs(2, 600, 48, 8, dtype, seed)
        r = scan_inputs(2, 600, 48, 8, dtype, seed + 50, D=False)
        label = f"bidir small G=2 L=600 d=48 N=8 {str(dtype)[6:]}"
        res.append({"case": label, **hold(label, TOL[dtype], *bidir_pair(f, r),
                                          bidir_names, tag="scan")})
    faults = {}
    for dtype, reverse in ((torch.bfloat16, False), (torch.bfloat16, True),
                           (torch.float32, False)):
        seed += 1
        inp = scan_inputs(4, 8192, 512, 16, dtype, seed, model_like=True)
        label = (f"scan fwd main G=4 L=8192 d=512 N=16 {str(dtype)[6:]} "
                 f"rev={reverse}")
        kernel, plain = scan_pair(inp, reverse)
        res.append({"case": label, **hold(label, TOL[dtype], kernel, plain,
                                          SCAN_FWD_NAMES, tag="scan")})
        if dtype != torch.bfloat16:
            continue
        bf16 = TOL[torch.bfloat16]
        # every scan direction: one run's incoming state dropped
        dropped, _ = scan_pair(inp, reverse, fault=DROP_RUN)
        faults[f"one run's incoming state dropped (rev={reverse})"] = hold(
            f"planted fault: one run's incoming state dropped "
            f"(rev={reverse})", bf16, dropped, plain, SCAN_FWD_NAMES,
            expect_ok=False, tag="scan")
        z = gate_of(inp, seed + 70)
        label = f"scan fwd gated main G=4 L=8192 d=512 N=16 bf16 rev={reverse}"
        res.append({"case": label, **hold(label, bf16, *scan_pair(
            inp, reverse, z=z), SCAN_FWD_NAMES, tag="scan")})
        del dropped, z
        if reverse:
            continue
        no_d, _ = scan_pair(inp, reverse, D=None)
        faults["D term dropped"] = hold(
            "planted fault: D term dropped", bf16, no_d, plain,
            SCAN_FWD_NAMES, expect_ok=False, tag="scan")
        y = kernel[0].clone()
        y[1, 37 * 64 + 16:37 * 64 + 32, 80:96] = 0
        faults["one 16x16 y tile zeroed"] = hold(
            "planted fault: one 16-row x 16-channel y tile zeroed", bf16,
            (y,) + kernel[1:], plain, SCAN_FWD_NAMES, expect_ok=False,
            tag="scan")
        del no_d, y
        r = scan_inputs(4, 8192, 512, 16, dtype, seed + 50, model_like=True)
        label = "bidir main G=4 L=8192 d=512 N=16 bf16"
        k2, p2 = bidir_pair(inp, r)
        res.append({"case": label, **hold(label, bf16, k2, p2, bidir_names,
                                          tag="scan")})
        k2, _ = bidir_pair(inp, r, A=inp["A"])
        faults["reverse set run with the forward set's A"] = hold(
            "planted fault: the reverse set run with the forward set's A",
            bf16, k2, p2, bidir_names, expect_ok=False, tag="scan")
        del r, k2, p2
        del inp, kernel, plain
    # the v1 prefill's shape (G=1, fp32: blocks of 4 warps) at a ragged L
    seed += 1
    inp = scan_inputs(1, 8000, 512, 16, torch.float32, seed, model_like=True)
    label = "scan fwd main G=1 L=8000 d=512 N=16 float32 (4-warp blocks)"
    res.append({"case": label, **hold(label, TOL[torch.float32],
                                      *scan_pair(inp, False), SCAN_FWD_NAMES,
                                      tag="scan")})
    return res, faults


def scan_bwd_pair(inp, reverse, fault=()):
    """`selective_scan_bwd` and its plain version from the same carries
    (the forward kernel's), nonzero h_init and g_hN; ``fault`` names a
    planted fault's build of the adjoint (`scan_fault`)."""
    from caduceus_tpu_torch.ops import scan
    from caduceus_tpu_torch.ops.selective_scan import selective_scan_bwd

    T = scan.KERNEL_CHUNK
    a = _scan_args(inp)
    _, _, car = scan.selective_scan_fwd(*a, True, reverse, T, inp["h0"],
                                        save_carries=True)
    with scan_fault(fault):
        kernel = scan.bwd_call(*a, inp["g_y"], car, inp["g_hN"], True,
                               reverse, T)[0]
    torch.cuda.synchronize()
    plain = selective_scan_bwd(*a, inp["g_y"], car, inp["g_hN"], True,
                               reverse, T)
    return kernel, plain


def phase_scan_bwd_checks():
    from caduceus_tpu_torch.kernel_check import TOL
    from caduceus_tpu_torch.ops.selective_scan import resolve_delta

    res, seed = [], 300
    for dtype in (torch.float32, torch.bfloat16):
        for L in (200, 600):
            for reverse in (False, True):
                seed += 1
                inp = scan_inputs(2, L, 48, 16, dtype, seed)
                label = (f"scan bwd small G=2 L={L} d=48 N=16 "
                         f"{str(dtype)[6:]} rev={reverse}")
                res.append({"case": label, **hold(
                    label, TOL[dtype], *scan_bwd_pair(inp, reverse),
                    SCAN_BWD_NAMES, tag="scan-bwd")})
    faults = {}
    for dtype, reverse in ((torch.bfloat16, False), (torch.bfloat16, True),
                           (torch.float32, False)):
        seed += 1
        inp = scan_inputs(4, 8192, 512, 16, dtype, seed, model_like=True)
        label = (f"scan bwd main G=4 L=8192 d=512 N=16 {str(dtype)[6:]} "
                 f"rev={reverse}")
        kernel, plain = scan_bwd_pair(inp, reverse)
        res.append({"case": label, **hold(label, TOL[dtype], kernel, plain,
                                          SCAN_BWD_NAMES, tag="scan-bwd")})
        if dtype != torch.bfloat16:
            continue
        bf16 = TOL[torch.bfloat16]
        # every scan direction: one run's incoming lam dropped
        dropped, _ = scan_bwd_pair(inp, reverse, fault=DROP_RUN)
        faults[f"one run's incoming lam dropped (rev={reverse})"] = hold(
            f"planted fault: one run's incoming lam dropped (rev={reverse})",
            bf16, dropped, plain, SCAN_BWD_NAMES, expect_ok=False,
            tag="scan-bwd")
        del dropped
        if reverse:
            continue
        dropped, _ = scan_bwd_pair(inp, reverse, fault=DROP_SHARE)
        faults["one cluster's g_B share left out"] = hold(
            "planted fault: one cluster's g_B share left out", bf16, dropped,
            plain, SCAN_BWD_NAMES, expect_ok=False, tag="scan-bwd")
        del dropped
        planted = {"g_A scaled by 1+2^-4": kernel[:2] + (
            kernel[2] * (1 + 2 ** -4),) + kernel[3:]}
        g_d = kernel[1].clone()
        g_d[1, 37 * 64 + 16:37 * 64 + 32, 80:96] = 0
        planted["one 16-row x 16-channel tile of g_delta zeroed"] = (
            kernel[:1] + (g_d,) + kernel[2:])
        sig = 1 - torch.exp(-resolve_delta(inp["delta"], inp["bias"], True))
        planted["the softplus chain dropped from g_delta"] = (
            kernel[:1] + ((kernel[1].float() / sig).to(dtype),) + kernel[2:])
        for name, out in planted.items():
            faults[name] = hold(f"planted fault: {name}", bf16, out, plain,
                                SCAN_BWD_NAMES, expect_ok=False,
                                tag="scan-bwd")
        del planted, g_d, sig
        del inp, kernel, plain
    return res, faults


def phase_v1_serve():
    """Serve the full-width hg38_mlm model (16 layers, random weights):
    /embed and /logits at bucket 1024 and one 131,072-token /logits; 16
    `bidir_scan_fwd` launches per dispatch; the served bf16 logits equal
    a direct forward."""
    from caduceus_tpu_torch.models.caduceus import CaduceusForMaskedLM
    from caduceus_tpu_torch.serve import InferenceServer, InferenceService

    cfg = hg38_mlm_config()
    model = CaduceusForMaskedLM(
        cfg, device="cpu", generator=torch.Generator().manual_seed(3333))
    svc = InferenceService(cfg, model.state_dict(), device="cuda",
                           max_batch=4, min_bucket=1024, max_length=131072)
    del model
    server = InferenceServer(svc, port=0).start()
    rng = np.random.default_rng(8)

    def seqs(*lengths):
        return ["".join(rng.choice(list("ACGT"), n)) for n in lengths]

    plan = [("/embed", seqs(1000)), ("/logits", seqs(900, 1024)),
            ("/logits", seqs(131072))]
    requests = []
    try:
        torch.cuda.reset_peak_memory_stats()
        d0 = svc.n_dispatches
        _zero_counts()
        for path, batch in plan:
            t0 = time.perf_counter()
            out = _post(server.port, path, {"sequences": batch})[path[1:]]
            dt = time.perf_counter() - t0
            ntok = sum(map(len, batch))
            for s_, o in zip(batch, out):
                a = np.asarray(o, np.float32)
                want = ((cfg.d_model,) if path == "/embed"
                        else (len(s_), cfg.padded_vocab_size))
                check(a.shape == want, f"{path}: shape {a.shape} != {want}")
                check(bool(np.isfinite(a).all()), f"{path}: non-finite")
            requests.append({"path": path, "n_seq": len(batch),
                             "tokens": ntok, "latency_s": dt,
                             "tokens_per_s": ntok / dt})
            log(f"[serve-v1] {path} {len(batch)} seq, {ntok} tokens: "
                f"{dt * 1e3:.1f} ms, {ntok / dt:,.0f} tokens/s")
            if path == "/logits" and len(batch) == 2:
                small = (batch, out)
        counts = _counts()
        dispatches = svc.n_dispatches - d0
        peak = torch.cuda.max_memory_allocated()
    finally:
        server.stop()
    launches = counts["bidir_scan_fwd"]
    log(f"[serve-v1] bidir_scan_fwd launches {launches} over {dispatches} "
        f"dispatches (expect {cfg.n_layer} each); peak memory "
        f"{peak / 2**30:.2f} GiB")
    check(dispatches == len(plan), f"{dispatches} dispatches for "
          f"{len(plan)} requests")
    want = dict.fromkeys(counts, 0)
    want["bidir_scan_fwd"] = cfg.n_layer * dispatches
    check(counts == want, f"serve launches {counts} != {want}")
    batch, out = small
    ids = torch.full((2, 1024), svc.tok.pad_token_id, dtype=torch.long)
    for i, s_ in enumerate(batch):
        ids[i, :len(s_)] = torch.from_numpy(
            svc.tok.encode(s_).astype(np.int64))
    with torch.inference_mode():
        direct = svc.model(ids.cuda()).cpu().numpy()
    for i, s_ in enumerate(batch):
        err = np.abs(np.asarray(out[i], np.float32)
                     - direct[i, :len(s_)]).max()
        check(err <= 1e-6, f"served v1 /logits differ from the model by {err}")
    long_ids = torch.from_numpy(
        svc.tok.encode(plan[-1][1][0]).astype(np.int64))[None].cuda()
    with torch.inference_mode():
        svc.model(long_ids)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc.model(long_ids)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
    log(f"[serve-v1] served bf16 logits equal a direct forward; direct "
        f"forward, 1 x 131072 tokens (no HTTP/JSON): {fwd_s * 1e3:.1f} ms")
    del svc
    torch.cuda.empty_cache()
    return {"requests": requests, "launches": launches,
            "dispatches": dispatches, "peak_mem_bytes": peak,
            "forward_131k_s": fwd_s}


# --- migrated weights: reference checkpoints imported (convert.py) -------

def _linear(g, n_out, n_in):
    """A torch-Linear-like weight (out, in): uniform within 1/sqrt(in)."""
    return (torch.rand(n_out, n_in, generator=g) * 2 - 1) * n_in ** -0.5


def _mamba_ref(g, prefix, d, di, N, R, K, in_proj=None, out_proj=None):
    """mamba-ssm `Mamba` parameters under ``prefix`` with the reference's
    init where it matters: A_log = log(1..N), D = 1, dt_proj's bias the
    inverse softplus of dt log-uniform in [1e-3, 0.1]."""
    dt = torch.exp(torch.rand(di, generator=g)
                   * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    return {
        f"{prefix}.in_proj.weight":
            _linear(g, 2 * di, d) if in_proj is None else in_proj,
        f"{prefix}.out_proj.weight":
            _linear(g, d, di) if out_proj is None else out_proj,
        f"{prefix}.conv1d.weight": _linear(g, di, K)[:, None, :],
        f"{prefix}.conv1d.bias": _linear(g, di, K)[:, 0],
        f"{prefix}.x_proj.weight": _linear(g, R + 2 * N, di),
        f"{prefix}.dt_proj.weight": _linear(g, di, R),
        f"{prefix}.dt_proj.bias": dt + torch.log(-torch.expm1(-dt)),
        f"{prefix}.A_log": torch.log(torch.arange(
            1, N + 1, dtype=torch.float32)).repeat(di, 1),
        f"{prefix}.D": torch.ones(di)}


def reference_caduceus_state(cfg, seed):
    """A reference-named `CaduceusForMaskedLM` state dict (RCPS, fused
    add-norm, tied BiMamba: the rev projections alias the fwd ones, the
    head the embedding) from a seeded `torch.Generator`."""
    g = torch.Generator().manual_seed(seed)
    d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_cfg.d_state
    R, K = cfg.dt_rank, cfg.ssm_cfg.d_conv
    emb = torch.randn(cfg.padded_vocab_size, d, generator=g) * 0.02
    sd = {"caduceus.backbone.embeddings.word_embeddings.embedding.weight":
          emb, "lm_head.lm_head.weight": emb}
    for i in range(cfg.n_layer):
        sd[f"caduceus.backbone.layers.{i}.norm.weight"] = \
            1 + 0.1 * torch.randn(d, generator=g)
        pre = f"caduceus.backbone.layers.{i}.mixer.submodule"
        fwd = _mamba_ref(g, f"{pre}.mamba_fwd", d, di, N, R, K)
        sd.update(fwd)
        sd.update(_mamba_ref(
            g, f"{pre}.mamba_rev", d, di, N, R, K,
            fwd[f"{pre}.mamba_fwd.in_proj.weight"],
            fwd[f"{pre}.mamba_fwd.out_proj.weight"]))
    sd["caduceus.backbone.norm_f.weight"] = 1 + 0.1 * torch.randn(d,
                                                                generator=g)
    return sd


def reference_mamba_state(cfg, seed):
    """A mamba-ssm `MixerModel` state dict under ``backbone.``."""
    g = torch.Generator().manual_seed(seed)
    d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_cfg.d_state
    sd = {"backbone.embedding.weight":
          torch.randn(cfg.padded_vocab_size, d, generator=g) * 0.02,
          "backbone.norm_f.weight": 1 + 0.1 * torch.randn(d, generator=g)}
    for i in range(cfg.n_layer):
        sd[f"backbone.layers.{i}.norm.weight"] = \
            1 + 0.1 * torch.randn(d, generator=g)
        sd.update(_mamba_ref(g, f"backbone.layers.{i}.mixer", d, di, N,
                             cfg.dt_rank, cfg.ssm_cfg.d_conv))
    return sd


def reference_hyena_state(kw, seed, order=64, K=3, emb_dim=3, inner=2):
    """A HyenaDNA `ConvLMHeadModel` state dict (order-2 Hyena operators,
    MHA at ``attn_layer_idx``, no position embedding): the filter's
    positional features and decay rates as the reference computes them."""
    from caduceus_tpu_torch.models.hyena import _pos_features

    g = torch.Generator().manual_seed(seed)
    d, V, Lmax = kw["d_model"], kw["vocab_size"], kw["l_max"]
    ln = lambda p: {f"{p}.weight": torch.ones(d), f"{p}.bias": torch.zeros(d)}

    def dense(p, n_out, n_in, bias=True):
        out = {f"{p}.weight": _linear(g, n_out, n_in)}
        if bias:
            out[f"{p}.bias"] = _linear(g, n_out, n_in)[:, 0]
        return out

    sd = {"backbone.embeddings.word_embeddings.weight":
          torch.randn(V, d, generator=g) * 0.02, **ln("backbone.ln_f")}
    z = _pos_features(Lmax, emb_dim)[0]
    for i in range(kw["n_layer"]):
        p = f"backbone.layers.{i}"
        sd.update({**ln(f"{p}.norm1"), **ln(f"{p}.norm2"),
                   **dense(f"{p}.mlp.fc1", 4 * d, d),
                   **dense(f"{p}.mlp.fc2", d, 4 * d)})
        m = f"{p}.mixer"
        if i in kw["attn_layer_idx"]:
            sd.update({**dense(f"{m}.Wqkv", 3 * d, d),
                       **dense(f"{m}.out_proj", d, d)})
            continue
        f = f"{m}.filter_fn"
        sd.update({**dense(f"{m}.in_proj", 3 * d, d),
                   **dense(f"{m}.out_proj", d, d),
                   f"{m}.short_filter.weight": _linear(g, 3 * d, K)[:, None],
                   f"{m}.short_filter.bias": _linear(g, 3 * d, K)[:, 0],
                   f"{f}.pos_emb.z": z[None].clone(),
                   f"{f}.implicit_filter.1.freq": torch.ones(1, order),
                   f"{f}.bias": torch.randn(d, generator=g),
                   f"{f}.modulation.deltas": torch.linspace(
                       math.log(1e-2) / 1.5, math.log(1e-2) / 0.3,
                       d)[None, None],
                   **dense(f"{f}.implicit_filter.0", order, emb_dim),
                   **dense(f"{f}.implicit_filter.{2 * (inner + 1)}", d, order,
                           bias=False)})
        for j in range(inner):
            sd.update(dense(f"{f}.implicit_filter.{2 * (j + 1)}", order,
                            order))
    return sd


def _card_vs_cpu(label, cpu_model, card_model, ids, rule="max"):
    """fp32 logits of the same weights on the card and on the CPU: "max"
    is `phase_model_vs_cpu`'s rule (max error within MODEL_TOL of
    max|logit|), "rel_l2" `phase_hyena_vs_cpu`'s (relative L2 within
    MODEL_TOL)."""
    with torch.inference_mode():
        t0 = time.perf_counter()
        ref = cpu_model(ids)
        t_cpu = time.perf_counter() - t0
        got = card_model(ids.cuda()).cpu()
    check(got.shape == ref.shape and bool(torch.isfinite(got).all()),
          f"[convert] {label}: logits {tuple(got.shape)}, finite "
          f"{bool(torch.isfinite(got).all())}")
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    rel_l2 = ((got - ref).norm() / ref.norm()).item()
    if rule == "max":
        check(err <= MODEL_TOL * scale, f"[convert] {label}: card vs CPU "
              f"{err:.3e} > {MODEL_TOL} x {scale:.3e}")
    else:
        check(rel_l2 <= MODEL_TOL, f"[convert] {label}: card vs CPU "
              f"rel_l2 {rel_l2:.2e} > {MODEL_TOL}")
    log(f"[convert] {label}: card vs CPU, fp32: max err {err:.3e} (max|logit| "
        f"{scale:.3e}), rel_l2 {rel_l2:.2e} (rule: {rule}, tol {MODEL_TOL}); "
        f"CPU forward {t_cpu:.1f} s")
    return {"max_abs_err": err, "max_abs_ref": scale, "rel_l2": rel_l2,
            "cpu_s": t_cpu}


def _rc_hold(label, model, cfg, L, seed, counted):
    """logits(RC(x)) against logits(x) flipped in L and permuted by the
    complement map, on the card: fp32 by the fp32 kernel rule of
    `kernel_check.py`, bf16 within BF16_MODEL_TOL of max|logit|; the
    launches of the two forwards of ``counted``."""
    from caduceus_tpu_torch.kernel_check import TOL, compare, describe

    cm = cfg.padded_complement_map()
    comp = torch.tensor([cm[i] for i in range(cfg.padded_vocab_size)],
                        device="cuda")
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(7, 11, (1, L), generator=g).cuda()
    _zero_counts()
    with torch.inference_mode():
        fwd = model(ids)
        rc = model(comp[ids.flip(-1)])
        torch.cuda.synchronize()
    launches = _counts()[counted]
    want = fwd.flip(1)[..., comp]
    check(bool(torch.isfinite(rc).all()), f"[convert] RC {label}: not finite")
    if cfg.dtype == "float32":
        st = compare(rc, want, TOL[torch.float32])
        check(st["ok"], f"[convert] RC {label}: {describe(st)}")
        out = {k: st[k] for k in ("rel_l2", "max_abs_err", "atol_needed")}
        shown = describe(st)
    else:
        err = (rc - want).abs().max().item()
        scale = want.abs().max().item()
        check(err <= BF16_MODEL_TOL * scale, f"[convert] RC {label}: "
              f"{err:.3e} > {BF16_MODEL_TOL} x {scale:.3e}")
        out = {"max_abs_err": err, "max_abs_ref": scale,
               "rel_l2": ((rc - want).norm() / want.norm()).item()}
        shown = (f"max err {err:.3e} = {err / scale:.2e} of max|logit| "
                 f"{scale:.3e} (tol {BF16_MODEL_TOL}), rel_l2 "
                 f"{out['rel_l2']:.2e}")
    check(launches == 2 * (cfg.n_layer if counted != "ssd_fused_fwd"
                           else 2 * cfg.n_layer),
          f"[convert] RC {label}: {counted} launches {launches}")
    out[f"{counted}_launches"] = launches
    log(f"[convert] RC {label} L={L}: logits(RC(x)) = flip_L(logits(x))"
        f"[..., complement]: {shown}; {counted} launches {launches}")
    return out


def phase_convert():
    """[convert] released PyTorch checkpoints into the port and onto the
    card (`caduceus_tpu_torch/convert.py`), from reference-named state
    dicts made from a seeded torch.Generator (the released files are not
    in the repository):

    - v1 Caduceus-PS at `configs/hg38_mlm.yaml`'s width (the released
      131k checkpoint's: d_model 256, 16 layers, d_state 16, RCPS, tied
      "add" BiMamba), saved as ``pytorch_model.bin``, read back by
      `load_torch_checkpoint`, imported and loaded on the card: the export
      of the card model gives the saved tensors back bit for bit; the
      weights written as a run dir (model_config.json + params.npz) and
      served give a 131,072-token bf16 /logits equal to a direct forward
      bit for bit, 16 `bidir_scan_fwd` launches a dispatch; 2 layers in
      fp32 at L=2048, card against CPU;
    - RC equivariance through the kernels at full width, for the imported
      v1 model (#9) and `hg38_mlm_v2` (#1, random weights): fp32 at
      L=16,384 by the fp32 kernel rule, bf16 at L=131,072 within 5e-2 of
      max|logit|;
    - a mamba-ssm `MixerModel` (non-RCPS, unidirectional, 4 layers at
      d_model 256) through `import_reference_mamba_backbone`: a bf16
      forward at L=131,072 through `selective_scan_fwd` (#7), fp32 card
      against CPU at L=2048;
    - a HyenaDNA `ConvLMHeadModel` at `configs/hg38_hyena.yaml`'s width (8
      layers, MHA at 1 and 5, 8 heads, 2 inner filter MLPs) through
      `import_reference_hyena_lm`: a bf16 forward at L=16,384 through
      `attn_fwd`, and fp32 card against CPU at L=16,384 by
      `phase_hyena_vs_cpu`'s rule."""
    from caduceus_tpu_torch import convert
    from caduceus_tpu_torch.models.caduceus import CaduceusForMaskedLM
    from caduceus_tpu_torch.models.hyena import HyenaLMHeadModel
    from caduceus_tpu_torch.params import from_jax_params
    from caduceus_tpu_torch.serve import InferenceServer, InferenceService

    t_phase = time.perf_counter()
    out = {}
    cfg = hg38_mlm_config()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_convert_") as work:
        saved = reference_caduceus_state(cfg, seed=14)
        path = os.path.join(work, "pytorch_model.bin")
        torch.save(saved, path)
        t0 = time.perf_counter()
        loaded = convert.load_torch_checkpoint(path)
        flat = convert.import_reference_state_dict(loaded, cfg)
        model = CaduceusForMaskedLM(cfg, device="cuda")
        model.load_state_dict(from_jax_params(flat, cfg))
        import_s = time.perf_counter() - t0
        back = convert.export_reference_state_dict(model.state_dict(), cfg)
        check(back.keys() == saved.keys(), "[convert] the export's names "
              f"differ: {sorted(set(back) ^ set(saved))[:6]}")
        same = [k for k in saved
                if torch.equal(torch.from_numpy(back[k]), saved[k])]
        check(len(same) == len(saved), f"[convert] the export differs from "
              f"the saved tensors in {len(saved) - len(same)} of "
              f"{len(saved)}")
        log(f"[convert] v1 hg38_mlm (16 layers, d_model 256): "
            f"{len(saved)} reference tensors saved, read, imported and "
            f"loaded on the card in {import_s:.2f} s; the card model's "
            "export equals them bit for bit")
        run = os.path.join(work, "imported_v1")
        os.makedirs(run)
        cfg.save(os.path.join(run, "model_config.json"))
        np.savez(os.path.join(run, "params.npz"), **flat)
        svc = InferenceService.from_run_dir(
            run, device="cuda", max_batch=1, min_bucket=1024,
            max_length=131072)
        seq = "".join(np.random.default_rng(14).choice(list("ACGT"), 131072))
        server = InferenceServer(svc, port=0).start()
        try:
            _zero_counts()
            d0 = svc.n_dispatches
            t0 = time.perf_counter()
            served = _post(server.port, "/logits",
                           {"sequences": [seq]})["logits"][0]
            latency = time.perf_counter() - t0
            counts = _counts()
            dispatches = svc.n_dispatches - d0
        finally:
            server.stop()
        tok = svc.tok
        del svc
        want = dict.fromkeys(counts, 0)
        want["bidir_scan_fwd"] = cfg.n_layer
        check(dispatches == 1 and counts == want,
              f"[convert] /logits: {dispatches} dispatches, launches {counts}")
        ids = torch.from_numpy(tok.encode(seq).astype(np.int64))[None].cuda()
        with torch.inference_mode():
            model(ids)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            direct = model(ids)
            torch.cuda.synchronize()
            fwd_s = time.perf_counter() - t0
        served = np.asarray(served, np.float32)
        direct = direct[0].cpu().numpy()
        check(served.shape == direct.shape == (131072, cfg.padded_vocab_size)
              and np.array_equal(served, direct),
              f"[convert] served /logits {served.shape} differ from the "
              f"direct forward {direct.shape}")
        check(bool(np.isfinite(direct).all()), "[convert] logits not finite")
        log(f"[convert] the imported weights as a run dir (model_config.json "
            f"+ params.npz), served: one 131,072-token /logits "
            f"{latency:.3f} s over HTTP, equal bit for bit to a direct "
            f"forward of the imported card model ({fwd_s * 1e3:.1f} ms); "
            f"bidir_scan_fwd launches {counts['bidir_scan_fwd']} in the "
            "dispatch")
        out["v1"] = {"tensors": len(saved), "import_s": import_s,
                     "logits_131k_s": latency, "forward_131k_s": fwd_s,
                     "launches_serve": counts["bidir_scan_fwd"]}
        del served, direct

    # (d) 2 layers, fp32, card against CPU on the same import
    cfg2 = hg38_mlm_config(n_layer=2, dtype="float32")
    sd2 = from_jax_params(convert.import_reference_state_dict(loaded, cfg2),
                          cfg2)
    cpu = CaduceusForMaskedLM(cfg2, device="cpu")
    cpu.load_state_dict(sd2)
    card = CaduceusForMaskedLM(cfg2, device="cuda")
    card.load_state_dict(sd2)
    ids = torch.randint(7, 11, (1, 2048),
                        generator=torch.Generator().manual_seed(15))
    out["v1"]["vs_cpu"] = _card_vs_cpu("v1 imported, 2 layers, L=2048", cpu,
                                       card, ids)
    del cpu, card

    # RC equivariance at full width: the imported v1 model, hg38_mlm_v2
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    m32 = CaduceusForMaskedLM(cfg32, device="cuda")
    m32.load_state_dict(model.state_dict())
    out["rc"] = {
        "v1_fp32_L16384": _rc_hold("v1 imported fp32", m32, cfg32, 16384, 16,
                                   "bidir_scan_fwd"),
        "v1_bf16_L131072": _rc_hold("v1 imported bf16", model, cfg, 131072,
                                    17, "bidir_scan_fwd")}
    del m32, model
    torch.cuda.empty_cache()
    v2 = hg38_mlm_v2_config()
    v2_cpu = CaduceusForMaskedLM(
        v2, device="cpu", generator=torch.Generator().manual_seed(18))
    for dtype, L in (("float32", 16384), ("bfloat16", 131072)):
        c = dataclasses.replace(v2, dtype=dtype)
        m = CaduceusForMaskedLM(c, device="cuda")
        m.load_state_dict(v2_cpu.state_dict())
        tag = "fp32" if dtype == "float32" else "bf16"
        out["rc"][f"v2_{tag}_L{L}"] = _rc_hold(f"hg38_mlm_v2 {tag}", m, c, L,
                                              19, "ssd_fused_fwd")
        del m
        torch.cuda.empty_cache()
    del v2_cpu

    # a mamba-ssm MixerModel: non-RCPS, unidirectional, 4 layers
    cm = hg38_mlm_config(n_layer=4, bidirectional=False)
    state = reference_mamba_state(cm, seed=20)
    flat = convert.import_reference_mamba_backbone(state, cm.n_layer)
    sd = from_jax_params(flat, cm)
    m = CaduceusForMaskedLM(cm, device="cuda")
    m.load_state_dict(sd)
    ids = torch.randint(7, 11, (1, 131072),
                        generator=torch.Generator().manual_seed(21)).cuda()
    _zero_counts()
    with torch.inference_mode():
        logits = m(ids)
        torch.cuda.synchronize()
    launches = _counts()["selective_scan_fwd"]
    check(tuple(logits.shape) == (1, 131072, cm.padded_vocab_size)
          and bool(torch.isfinite(logits).all()) and launches == cm.n_layer,
          f"[convert] mamba backbone: logits {tuple(logits.shape)}, "
          f"selective_scan_fwd launches {launches}")
    log(f"[convert] mamba-ssm MixerModel (4 layers, d_model 256, "
        f"unidirectional) imported: bf16 forward at L=131072 finite, "
        f"selective_scan_fwd launches {launches}")
    del m, logits
    c32 = dataclasses.replace(cm, dtype="float32")
    cpu = CaduceusForMaskedLM(c32, device="cpu")
    cpu.load_state_dict(sd)
    card = CaduceusForMaskedLM(c32, device="cuda")
    card.load_state_dict(sd)
    ids = torch.randint(7, 11, (1, 2048),
                        generator=torch.Generator().manual_seed(22))
    out["mamba"] = {"launches": launches, "vs_cpu": _card_vs_cpu(
        "mamba backbone, 4 layers, L=2048", cpu, card, ids)}
    del cpu, card

    # a HyenaDNA ConvLMHeadModel at hg38_hyena's width
    kw = dict(d_model=256, n_layer=8, vocab_size=12, l_max=65536,
              attn_layer_idx=(1, 5), num_heads=8)
    flat = convert.import_reference_hyena_lm(
        reference_hyena_state(kw, seed=23), kw["n_layer"],
        kw["attn_layer_idx"], num_inner_mlps=2)
    models = {}
    for dev, dtype in (("cpu", "float32"), ("cuda", "float32"),
                       ("cuda", "bfloat16")):
        m = HyenaLMHeadModel(device=dev, dtype=dtype, **kw)
        m.load_state_dict(from_jax_params(flat, None, model=m))
        models[(dev, dtype)] = m
    ids = torch.from_numpy(np.random.default_rng(24).integers(
        0, 12, (1, 16384)))
    _attn_zero()
    with torch.inference_mode():
        logits = models[("cuda", "bfloat16")](ids.cuda())
        torch.cuda.synchronize()
    counts = _attn_counts()
    check(bool(torch.isfinite(logits).all())
          and counts == {"attn_fwd": 2, "attn_bwd_dkv": 0, "attn_bwd_dq": 0},
          f"[convert] Hyena LM bf16: finite "
          f"{bool(torch.isfinite(logits).all())}, attention launches "
          f"{counts}")
    log(f"[convert] HyenaDNA ConvLMHeadModel (8 layers, MHA at 1 and 5) "
        f"imported: bf16 forward at L=16384 finite, attention launches "
        f"{counts}")
    out["hyena"] = {"launches": counts["attn_fwd"], "vs_cpu": _card_vs_cpu(
        "Hyena LM, 8 layers, L=16384", models[("cpu", "float32")],
        models[("cuda", "float32")], ids, rule="rel_l2")}
    del models, logits
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[convert] phase {out['phase_s']:.1f} s")
    return out


def phase_mamba_mixer_step():
    """The unidirectional v1 mixer (`MambaMixer`, `bidirectional=False`,
    the mixer of configs/hg38_mamba_ntp.yaml) through `make_train_step`:
    full width, 2 layers, L=8192, bf16, accum 2; it runs
    `selective_scan_fwd` (#7) and `selective_scan_bwd`."""
    from caduceus_tpu_torch.models.caduceus import CaduceusForMaskedLM
    from caduceus_tpu_torch.train.optim import make_optimizer
    from caduceus_tpu_torch.train.trainer import TrainState, make_train_step

    cfg = hg38_mlm_config(n_layer=2, bidirectional=False)
    model = CaduceusForMaskedLM(cfg, device="cuda",
                                generator=torch.Generator().manual_seed(5))
    opt, _ = make_optimizer(model.named_parameters(), lr=8e-3, warmup_t=100,
                            t_initial=50_000)
    gen = torch.Generator(device="cuda").manual_seed(6)
    batch = {"input_ids": torch.randint(7, 11, (4, 8192), generator=gen,
                                        device="cuda"),
             "targets": torch.randint(0, 12, (4, 8192), generator=gen,
                                      device="cuda")}
    _zero_counts()
    t0 = time.perf_counter()
    _, m = make_train_step(accum_steps=2)(TrainState(model, opt), batch)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _counts()
    want = {k: v * 2 for k, v in _per_micro_batch(cfg).items()}
    m = {k: float(v) for k, v in m.items()}
    log(f"[train] MambaMixer (unidirectional v1), 2 layers, L=8192, accum 2: "
        f"loss {m['loss']:.5f}, grad_norm {m['grad_norm']:.4f}, "
        f"{secs:.2f} s (first call); launches {counts}")
    check(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]),
          f"MambaMixer step: {m}")
    check(counts == want, f"MambaMixer launches {counts} != {want}")
    return {"launches": counts, "step_s": secs, **m}


def phase_scan_timing():
    """The scan kernels at the training shape (G=4, L=131072, bf16, d=512,
    N=16) beside their plain versions and bounds; #7 also at the v1
    prefill's shape (G=1, fp32) and with the SiLU(z) gate; #8's two
    sub-launches (main pass, g_B / g_C share sum) each alone beside the
    bytes it must move. The timed outputs are held against the plain
    ones. Exps: one per (row, channel, n) and direction, the dA the
    kernels keep for every walk; beside them, per (row, channel), the
    softplus (an exp and a log1p) and, in the adjoint, its chain's exp."""
    from caduceus_tpu_torch.kernel_check import TOL
    from caduceus_tpu_torch.ops import scan
    from caduceus_tpu_torch.ops import selective_scan as plain

    G, L, d, N = 4, 131072, 512, 16
    T = scan.KERNEL_CHUNK
    rows, nc = G * L, -(-L // T)
    bf16 = TOL[torch.bfloat16]
    car_bytes = G * nc * d * N * 4
    # per row and direction: u, delta read, B, C read (bf16), y written
    io_fwd = rows * (2 * d * 2 + 2 * N * 2 + d * 2)
    res = {}
    f = scan_inputs(G, L, d, N, torch.bfloat16, 401, model_like=True)
    r = scan_inputs(G, L, d, N, torch.bfloat16, 402, model_like=True)
    a, b = _scan_args(f), _scan_args(r)
    outs = {}

    t = _timed(lambda: outs.__setitem__("k", scan.selective_scan_fwd(
                   *a, True, False, T, None, save_carries=True)),
               lambda: outs.__setitem__("p", plain.selective_scan(
                   *a, True, False, T, None, True, True)))
    t["check"] = hold(f"timed selective_scan_fwd + carries G=4 L={L} bf16",
                      bf16, outs.pop("k"), outs.pop("p"), SCAN_FWD_NAMES,
                      tag="scan")
    # fp32 FLOP on the non-tensor-core units; the exps (MUFU, 16 per clock
    # per SM) stand beside the bound, not in it
    t.update(_bound(io_fwd + car_bytes, 5 * rows * d * N, FP32_FLOP_PER_S))
    t["exps"], t["exps_softplus"] = rows * d * N, 2 * rows * d
    res["fwd"] = t

    z = gate_of(f, 403)
    t = _timed(lambda: outs.__setitem__("k", scan.selective_scan_fwd(
                   *a, True, False, T, None, save_carries=True, z=z)),
               lambda: outs.__setitem__("p", plain.selective_scan(
                   *a, True, False, T, None, True, True, z=z)))
    t["check"] = hold(f"timed gated selective_scan_fwd + carries G=4 L={L} "
                      "bf16", bf16, outs.pop("k"), outs.pop("p"),
                      SCAN_FWD_NAMES, tag="scan")
    t.update(_bound(io_fwd + rows * d * 2 + car_bytes,
                    5 * rows * d * N + 4 * rows * d, FP32_FLOP_PER_S))
    t["exps"], t["exps_softplus"] = rows * d * N + rows * d, 2 * rows * d
    res["fwd_gated"] = t
    del z

    # the v1 prefill's call: one sequence, the scan in fp32 (B and C column
    # views of the fp32 x_proj output), from a state
    f1 = scan_inputs(1, L, d, N, torch.float32, 404, model_like=True)
    a1 = _scan_args(f1)
    rows1 = L
    t = _timed(lambda: outs.__setitem__("k", scan.selective_scan_fwd(
                   *a1, True, False, T, f1["h0"])[:2]),
               lambda: outs.__setitem__("p", plain.selective_scan(
                   *a1, True, False, T, f1["h0"], True)))
    t["check"] = hold(f"timed selective_scan_fwd G=1 L={L} fp32 (prefill)",
                      TOL[torch.float32], outs.pop("k"), outs.pop("p"),
                      ("y", "hN"), tag="scan")
    t.update(_bound(rows1 * (2 * d * 4 + 2 * N * 4 + d * 4) + 2 * d * N * 4,
                    5 * rows1 * d * N, FP32_FLOP_PER_S))
    t["exps"], t["exps_softplus"] = rows1 * d * N, 2 * rows1 * d
    res["fwd_G1_fp32"] = t
    del f1, a1
    # the same in bf16 (a prefill whose scan is not promoted): 8-byte rows
    # of the 4-warp blocks' channels, staged by plain loads
    f1 = scan_inputs(1, L, d, N, torch.bfloat16, 405, model_like=True)
    a1 = _scan_args(f1)
    t = _timed(lambda: outs.__setitem__("k", scan.selective_scan_fwd(
                   *a1, True, False, T, f1["h0"])[:2]),
               lambda: outs.__setitem__("p", plain.selective_scan(
                   *a1, True, False, T, f1["h0"], True)))
    t["check"] = hold(f"timed selective_scan_fwd G=1 L={L} bf16", bf16,
                      outs.pop("k"), outs.pop("p"), ("y", "hN"), tag="scan")
    t.update(_bound(rows1 * (3 * d * 2 + 2 * N * 2) + 2 * d * N * 4,
                    5 * rows1 * d * N, FP32_FLOP_PER_S))
    t["exps"], t["exps_softplus"] = rows1 * d * N, 2 * rows1 * d
    res["fwd_G1_bf16"] = t
    del f1, a1

    t = _timed(lambda: outs.__setitem__("k", scan.bidir_scan_fwd(
                   *a[:2], *a[3:5], *b[:2], *b[3:5], a[2], b[2], a[5], b[5],
                   a[6], b[6], save_carries=True)),
               lambda: outs.__setitem__("p", plain.selective_scan(
                   *a, True, False, T, return_carries=True)
                   + plain.selective_scan(*b, True, True, T,
                                          return_carries=True)))
    k = outs.pop("k")
    t["check"] = hold(f"timed bidir_scan_fwd + carries G=4 L={L} bf16", bf16,
                      (k[0], k[2], k[1], k[3]), outs.pop("p"),
                      ("yf", "carf", "yr", "carr"), tag="scan")
    car = k[2]
    del k
    bounds = _scan_bounds(G, L, d, N, T)
    t.update(bounds["bidir_scan_fwd"])
    t["exps"], t["exps_softplus"] = 2 * rows * d * N, 2 * 2 * rows * d
    res["bidir"] = t

    bwd_args = a + [f["g_y"], car, None, True, False, T]
    t = _timed(lambda: outs.__setitem__("k", scan.selective_scan_bwd_cuda(
                   *bwd_args)),
               lambda: outs.__setitem__("p", plain.selective_scan_bwd(
                   *bwd_args)))
    t["check"] = hold(f"timed selective_scan_bwd G=4 L={L} bf16", bf16,
                      outs.pop("k"), outs.pop("p"), SCAN_BWD_NAMES,
                      tag="scan-bwd")
    # reads u, delta, g_y, B, C and the carries; writes g_u, g_delta, g_B,
    # g_C; the fp32 g_B / g_C shares (written by the main pass, read by the
    # share sum) stand beside it as extra_bytes
    t.update(bounds["selective_scan_bwd"])
    nsh = scan.n_bc_shares(d)
    share_bytes = nsh * 2 * rows * N * 4
    t["exps"], t["exps_softplus"] = rows * d * N + rows * d, 2 * rows * d
    t["extra_bytes"] = 2 * share_bytes
    t["bc_shares"] = nsh
    o = scan.bwd_call(*bwd_args)[1]
    t["sub_launches"] = {}
    for name, part, nbytes in (
            ("main pass", scan.PART_MAIN,
             rows * (3 * d * 2 + 2 * N * 2 + 2 * d * 2) + car_bytes
             + share_bytes),
            ("share sum", scan.PART_SUM, share_bytes + rows * 2 * N * 2)):
        ms = _time_cuda(lambda: scan.bwd_call(*bwd_args, parts=part, out=o), 3)
        t["sub_launches"][name] = {"ms": ms, "bytes": nbytes,
                                   "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    log("[time]   scan bwd sub-launches: " + "; ".join(
        f"{k} {v['ms']:.3f} ms ({v['bytes'] / 1e9:.3f} GB, "
        f"{v['bytes_ms']:.3f} ms at {HBM_BYTES_PER_S / 1e12:.2f} TB/s)"
        for k, v in t["sub_launches"].items()))
    del o
    res["bwd"] = t
    for name, t in res.items():
        # MUFU exp2: 16 per clock per SM, 132 SMs at 1.98 GHz
        t["exp_ms"] = t["exps"] / (16 * 132 * 1.98e9) * 1e3
        shape = {"fwd_G1_fp32": f"G=1 L={L} fp32",
                 "fwd_G1_bf16": f"G=1 L={L} bf16"}.get(name, f"G=4 L={L} bf16")
        log(f"[time] scan {name} {shape}: kernel {t['ms']:.3f} ms "
            f"(runs {', '.join(f'{v:.3f}' for v in t['kernel_ms_runs'])}), "
            f"plain {t['plain_ms']:.1f} ms, bound {t['bound_ms']:.3f} ms "
            f"({t['bound_by']}: {t['bytes'] / 1e9:.2f} GB, "
            f"{t['flops'] / 1e9:.1f} GFLOP); {t['exps'] / 1e9:.2f}e9 exps "
            f"(one per (row, channel, n){' and the chain' if name == 'bwd' else ''}"
            f"{' and the gate' if name == 'fwd_gated' else ''}) "
            f"= {t['exp_ms']:.3f} ms at the MUFU rate, "
            f"{t['exps_softplus'] / 1e9:.2f}e9 in the softplus")
    return res


# --- generation: the prefill (unfused SSD #2 for v2, #7 for v1), the decode
# step and /generate, for both causal families ---------------------------


def mamba_ntp_config(version: int, n_layer: int = 16,
                     dtype: str = "bfloat16", use_kernel: str = "auto"):
    """The causal models of `cli.py pretrain --model mamba --ntp` (rcps and
    bidirectional off, the `CaduceusConfig` defaults otherwise), written
    out (no YAML). v1: `configs/hg38_mamba_ntp.yaml` (d_model 256, 16
    layers, d_inner 512, d_state 16, dt_rank 16, d_conv 4). v2: the same
    with `--preset configs/hg38_mlm_v2.yaml`'s mixer (d_state 128, headdim
    64, ngroups 1, 8 heads)."""
    from caduceus_tpu_torch.config import CaduceusConfig, SSMConfig
    from caduceus_tpu_torch.tokenization import CaduceusTokenizer

    tok = CaduceusTokenizer()
    ssm = (SSMConfig(version=2, d_state=128, headdim=64, ngroups=1, d_conv=4,
                     expand=2, ssd_chunk_size=128, ssd_seg_chunks=8,
                     use_kernel=use_kernel)
           if version == 2 else SSMConfig(version=1, d_state=16, d_conv=4,
                                          expand=2))
    return CaduceusConfig(
        d_model=256, n_layer=n_layer, vocab_size=tok.vocab_size, rcps=False,
        complement_map=tok.complement_map, bidirectional=False,
        dtype=dtype, param_dtype="float32", remat=True, ssm_cfg=ssm)


def unfused_inputs(G, L, H, P, NG, N, dtype, seed, pad=0):
    """Seeded operands of the unfused SSD on the card: x, B and C are column
    views of one (G, L, pad + H·P + 2·NG·N) tensor (the prefill's conv
    output) and dt a column view of a wider one (the in_proj output); with
    the backward's cotangents g_y and g_hN."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    xc = rnd(G, L, pad + H * P + 2 * NG * N).to(dtype)
    o = pad + H * P
    return dict(
        x=xc[..., pad:o].reshape(G, L, H, P),
        B=xc[..., o:o + NG * N].reshape(G, L, NG, N),
        C=xc[..., o + NG * N:].reshape(G, L, NG, N),
        dt=(rnd(G, L, H + 8) * 0.5).to(dtype)[..., 8:],
        A=-torch.exp(rnd(H, scale=0.5)), D=rnd(H), dt_bias=rnd(H, scale=0.1),
        h_init=rnd(G, H, N, P), g_y=rnd(G, L, H, P).to(dtype),
        g_hN=rnd(G, H, N, P))


def _unfused_args(inp, **over):
    k = {**inp, **over}
    return [k[n] for n in ("x", "dt", "A", "B", "C", "D", "dt_bias")]


def unfused_pair(inp, reverse, **over):
    """`ssd_fwd` and its plain version `ssd_chunked` on the same card
    tensors: (y, hN, carries) of each. ``over`` replaces inputs of the
    kernel's run only."""
    from caduceus_tpu_torch.ops.ssd import ssd_chunked
    from caduceus_tpu_torch.ops.ssd_batched import KERNEL_CHUNK, ssd_fwd

    T = KERNEL_CHUNK[inp["x"].dtype]
    k = {**inp, **over}
    kernel = ssd_fwd(*_unfused_args(inp, **over), True, reverse, T,
                     k["h_init"], save_carries=True)
    torch.cuda.synchronize()
    plain = ssd_chunked(*_unfused_args(inp), True, reverse, T, inp["h_init"],
                        return_carries=True)
    return kernel, plain


def phase_unfused_checks():
    """`ssd_fwd` (TPU kernel #2) against `ssd_chunked`: small shapes, the
    main geometry, and planted faults that must fail."""
    from caduceus_tpu_torch.kernel_check import TOL

    results, faults, seed = [], {}, 500
    for dtype in (torch.float32, torch.bfloat16):
        for NG in (1, 2):
            for reverse in (False, True):
                seed += 1
                inp = unfused_inputs(2, 200, 4, 32, NG, 32, dtype, seed,
                                     pad=16)
                label = (f"unfused small G=2 L=200 H=4 P=32 NG={NG} N=32 "
                         f"{str(dtype)[6:]} rev={reverse}")
                results.append({"case": label, **hold(
                    label, TOL[dtype], *unfused_pair(inp, reverse),
                    tag="ssd-unfused")})
    for dtype, reverse in ((torch.bfloat16, False), (torch.bfloat16, True),
                           (torch.float32, False)):
        seed += 1
        inp = unfused_inputs(4, 8192, 8, 64, 1, 128, dtype, seed, pad=0)
        label = (f"unfused main G=4 L=8192 H=8 P=64 N=128 {str(dtype)[6:]} "
                 f"rev={reverse}")
        kernel, plain = unfused_pair(inp, reverse)
        results.append({"case": label, **hold(label, TOL[dtype], kernel,
                                              plain, tag="ssd-unfused")})
        if faults:
            continue
        bf16 = TOL[torch.bfloat16]
        no_d, _ = unfused_pair(inp, reverse, D=torch.zeros_like(inp["D"]))
        planted = {"D term dropped": no_d}
        y = kernel[0].clone()
        t0 = 37 * 64 + 16                 # rows 16..31 of chunk 37
        y[1, t0:t0 + 16, 5, 48:64] = 0
        planted["one y tile (g1, h5, p48-63) zeroed"] = (y,) + kernel[1:]
        no_h0, _ = unfused_pair(inp, reverse, h_init=None)
        planted["h_init ignored"] = no_h0
        for name, out in planted.items():
            faults[name] = hold(f"planted fault: {name}", bf16, out, plain,
                                expect_ok=False, tag="ssd-unfused")
        del planted, no_d, no_h0, y
        del inp, kernel, plain
    return results, faults


def _close(label, got, want, tol):
    """max |got - want| <= tol x max|want|, on the CPU."""
    got, want = got.float().cpu(), want.float().cpu()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite")
    check(err <= tol * scale, f"{label}: {err:.3e} > {tol} x {scale:.3e}")
    return err / max(scale, 1e-30)


def _cache_close(label, got, want, tol):
    return max(_close(f"{label} {k} {n}", got[k]["fwd"][n], want[k]["fwd"][n],
                      tol) for k in want for n in ("conv", "ssm"))


def _scan_counter(cfg):
    """The launch counter of the prefill's scan kernel."""
    if cfg.ssm_cfg.version == 1:
        return "selective_scan_fwd"
    return "ssd_head_fwd" if _per_head(cfg) else "ssd_fwd"


def phase_prefill_vs_cpu(version, use_kernel="auto"):
    """The full-width causal model at 2 layers, fp32: `prefill` on the card
    against the CPU from the same weights (logits and every cache entry), a
    prompt split in two chained prefills against one call, and greedy
    `generate` of 32 tokens against the CPU's tokens and the argmax of the
    card's full forward."""
    from caduceus_tpu_torch.inference import generate, prefill
    from caduceus_tpu_torch.models.caduceus import CaduceusForMaskedLM

    cfg = mamba_ntp_config(version, n_layer=2, dtype="float32",
                           use_kernel=use_kernel)
    gen = torch.Generator().manual_seed(40 + version)
    cpu = CaduceusForMaskedLM(cfg, device="cpu", generator=gen)
    card = CaduceusForMaskedLM(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    B, L, n_new = 2, 1500, 32
    ids = torch.randint(7, 11, (B, L), generator=gen)
    _zero_counts()
    logits, caches = prefill(card, ids.cuda())
    torch.cuda.synchronize()
    counts = _counts()
    want = dict.fromkeys(counts, 0)
    want[_scan_counter(cfg)] = cfg.n_layer
    check(counts == want, f"prefill launches {counts} != {want}")
    t0 = time.perf_counter()
    ref_logits, ref_caches = prefill(cpu, ids)
    t_cpu = time.perf_counter() - t0
    res = {"logits": _close("card vs CPU prefill logits", logits, ref_logits,
                            MODEL_TOL),
           "caches": _cache_close("card vs CPU prefill cache", caches,
                                  ref_caches, MODEL_TOL)}
    # two chained prefills (split inside a chunk, and before d_conv rows)
    chained = {}
    for split in (700, 3):
        _, c1 = prefill(card, ids[:, :split].cuda())
        l2, c2 = prefill(card, ids[:, split:].cuda(), caches=c1)
        chained[split] = max(
            _close(f"chained prefill at {split}: logits", l2, logits, 1e-4),
            _cache_close(f"chained prefill at {split}: cache", c2, caches,
                         1e-4))
    res["chained"] = chained
    out = generate(card, ids.cuda(), n_new).cpu()
    ref = generate(cpu, ids, n_new)
    check(torch.equal(out, ref), f"greedy tokens card {out[:, L:].tolist()} "
          f"vs CPU {ref[:, L:].tolist()}")
    with torch.inference_mode():
        full = card(out[:, :-1].cuda()).argmax(-1).cpu()
    check(torch.equal(full[:, L - 1:], out[:, L:]),
          "greedy tokens differ from the argmax of the card's full forward")
    log(f"[prefill] v{version} causal (use_kernel {use_kernel}), full "
        f"width, 2 layers, fp32, B={B}, "
        f"L={L}: card vs CPU logits {res['logits']:.2e}, caches "
        f"{res['caches']:.2e} of max (tol {MODEL_TOL}); chained prefills "
        f"(split 700, 3) vs one call {max(chained.values()):.2e} of max "
        f"(tol 1e-4); greedy {n_new} tokens equal to the CPU's and to the "
        f"argmax of the card's full forward; launches {counts}; CPU prefill "
        f"{t_cpu:.2f} s")
    return {**res, "launches": counts, "cpu_prefill_s": t_cpu}


def _prefill_bound(cfg, L, B=1):
    """The least time of a bf16 model's prefill of B x L tokens: every
    layer's scan kernel's bytes (as its own bound) plus the layer's hidden
    state in and out, and the operations: the projections at the bf16
    tensor-core peak, the scan at the fp32 peak (with a conv bias the
    scan's operands are fp32, as in the JAX prefill; `inference._conv_tail`)
    or the bf16 one; the conv, norms and the rest add to it."""
    c, s = cfg, cfg.ssm_cfg
    rows = B * L
    d, di = c.d_model, c.d_inner
    es = 4 if s.conv_bias else 2   # bytes per scan operand
    if s.version == 2:
        H, P, NG, N = c.nheads, s.headdim, s.ngroups, s.d_state
        T = 32 if s.conv_bias else 64
        proj = 2 * d * (2 * di + 2 * NG * N + H) + 2 * di * d
        scan_bytes = rows * ((H * P + 2 * NG * N + H) * es + H * P * es)
        scan_ops = rows * (2 * T * N * NG + 2 * T * P * H + 4 * N * P * H)
    else:
        N, R = s.d_state, c.dt_rank
        proj = 2 * d * 2 * di + 2 * di * (R + 2 * N) + 2 * R * di + 2 * di * d
        scan_bytes = rows * (2 * di * es + 2 * N * es + di * es)
        scan_ops = 5 * rows * di * N
    n = c.n_layer
    nbytes = n * (scan_bytes + rows * d * 2 * 2)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = (n * rows * proj / BF16_FLOP_PER_S + n * scan_ops
              / (FP32_FLOP_PER_S if s.conv_bias else BF16_FLOP_PER_S)) * 1e3
    return {"bytes": nbytes, "flops": n * (scan_ops + rows * proj),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def _bf16_conv_tail(dparams, x_ext):
    """The prefill's conv with its bias cast to the input's dtype, so that a
    bf16 model's scan runs in bf16: the rule before `inference._conv_tail`
    mirrored the JAX prefill's fp32 promotion; timed beside it."""
    from caduceus_tpu_torch.ops.conv import causal_conv1d

    K = dparams.conv_w.shape[0]
    b = None if dparams.conv_b is None else dparams.conv_b.to(x_ext.dtype)
    return causal_conv1d(x_ext, dparams.conv_w.to(x_ext.dtype), b,
                         activation="silu")[:, K - 1:]


def phase_generate_serve(version):
    """The full-width 16-layer causal model served over HTTP: /generate
    with prompts of 1,000 and 131,072 tokens, 64 new tokens each; the
    prefill launches its scan kernel once per layer and decoding none; a
    bf16 prefill's last logits against the full forward's last position;
    prefill tokens/s, decode ms per token at batch 1 and 8, /generate
    latency, each beside its bound."""
    from caduceus_tpu_torch import inference
    from caduceus_tpu_torch.inference import lm_step, prefill
    from caduceus_tpu_torch.models.caduceus import CaduceusForMaskedLM
    from caduceus_tpu_torch.serve import InferenceServer, InferenceService

    cfg = mamba_ntp_config(version)
    model = CaduceusForMaskedLM(
        cfg, device="cpu", generator=torch.Generator().manual_seed(60 + version))
    svc = InferenceService(cfg, model.state_dict(), device="cuda",
                           max_batch=4, min_bucket=1024, max_length=131072)
    del model
    server = InferenceServer(svc, port=0).start()
    rng = np.random.default_rng(9 + version)
    prompts = ["".join(rng.choice(list("ACGT"), n)) for n in (1000, 131072)]
    n_new, requests = 64, []
    counter = _scan_counter(cfg)
    try:
        _zero_counts()
        for prompt in prompts:
            t0 = time.perf_counter()
            out = _post(server.port, "/generate",
                        {"prompt": prompt, "max_new_tokens": n_new})
            dt = time.perf_counter() - t0
            check(out["prompt"] == prompt and len(out["generated"]) >= n_new,
                  f"/generate: {str(out)[:200]}")
            requests.append({"prompt_tokens": len(prompt), "new": n_new,
                             "latency_s": dt})
            log(f"[generate] v{version} /generate {len(prompt)} + {n_new} "
                f"tokens: {dt * 1e3:.1f} ms over HTTP")
        counts = _counts()
        # the long request again with the prefill's scan in bf16 (its conv
        # bias cast to bf16, as before the JAX prefill's fp32 promotion was
        # mirrored): a time to compare, not a path of the port
        with mock.patch.object(inference, "_conv_tail", _bf16_conv_tail):
            t0 = time.perf_counter()
            _post(server.port, "/generate",
                  {"prompt": prompts[-1], "max_new_tokens": n_new})
            bf16_generate_s = time.perf_counter() - t0
    finally:
        server.stop()
    want = dict.fromkeys(counts, 0)
    want[counter] = cfg.n_layer * len(prompts)
    check(counts == want, f"/generate launches {counts} != {want} (the "
          f"prefill: {cfg.n_layer} per request; decoding: none)")
    res = {"requests": requests, "launches": counts[counter],
           "bf16_prefill_vs_forward": {}}
    model = svc.model
    tok = svc.tok
    with torch.inference_mode():
        for prompt in prompts:
            ids = torch.from_numpy(tok.encode(prompt).astype(np.int64))[
                None].cuda()
            last, _ = prefill(model, ids)
            full = model(ids)[:, -1]
            res["bf16_prefill_vs_forward"][len(prompt)] = _close(
                f"bf16 prefill vs full forward, last position, L="
                f"{len(prompt)}", last, full, BF16_MODEL_TOL)
        # prefill rate at 131,072 tokens (warm: the requests above ran it)
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(model, ids)
        torch.cuda.synchronize()
        res["prefill_s"] = time.perf_counter() - t0
        check(_counts()[counter] == cfg.n_layer, "prefill launches")
        res["prefill_tokens_per_s"] = ids.shape[1] / res["prefill_s"]
        res["prefill_bound"] = _prefill_bound(cfg, ids.shape[1])
        with mock.patch.object(inference, "_conv_tail", _bf16_conv_tail):
            prefill(model, ids)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prefill(model, ids)
            torch.cuda.synchronize()
            res["prefill_bf16_scan_s"] = time.perf_counter() - t0
        res["generate_bf16_scan_s"] = bf16_generate_s
        log(f"[generate] v{version} with the prefill's scan in bf16 (the "
            f"earlier rule; time only): prefill 1 x {ids.shape[1]} "
            f"{res['prefill_bf16_scan_s'] * 1e3:.1f} ms, /generate "
            f"{ids.shape[1]} + {n_new} over HTTP {bf16_generate_s * 1e3:.1f} "
            f"ms (fp32 scan: {res['prefill_s'] * 1e3:.1f} ms, "
            f"{requests[-1]['latency_s'] * 1e3:.1f} ms)")
        # decode: ms per token after a 1,000-token prompt, batch 1 and 8
        n_params = sum(p.numel() for p in model.parameters())
        for B in (1, 8):
            short = ids[:, :1000].expand(B, -1).contiguous()
            logits, caches = prefill(model, short)
            tok_t = logits.argmax(-1)
            lm_step(model, tok_t, caches)
            _zero_counts()
            steps = 32
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                logits, caches = lm_step(model, tok_t, caches)
                tok_t = logits.argmax(-1)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / steps * 1e3
            check(all(v == 0 for v in _counts().values()),
                  "the decode step launched a scan kernel")
            state = sum(t.numel() * t.element_size() for layer in
                        caches.values() for t in layer["fwd"].values())
            # weights read once (fp32), caches read and written once
            bound = _bound(n_params * 4 + 2 * state,
                           2 * n_params * B)
            res[f"decode_B{B}"] = {"ms_per_token": ms, **bound}
            log(f"[generate] v{version} decode, batch {B}: {ms:.3f} ms per "
                f"token ({B * 1e3 / ms:,.0f} tokens/s), bound "
                f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})")
    pb = res["prefill_bound"]
    res["generate_bound_ms"] = pb["bound_ms"] + n_new * res["decode_B1"][
        "bound_ms"]
    log(f"[generate] v{version} prefill 1 x {ids.shape[1]}: "
        f"{res['prefill_s'] * 1e3:.1f} ms, {res['prefill_tokens_per_s']:,.0f} "
        f"tokens/s, bound {pb['bound_ms']:.3f} ms ({pb['bound_by']}); "
        f"/generate {ids.shape[1]} + {n_new} over HTTP "
        f"{requests[-1]['latency_s'] * 1e3:.1f} ms, bound "
        f"{res['generate_bound_ms']:.3f} ms; launches {counts}; bf16 "
        f"prefill vs full forward (last position) at L = "
        + ", ".join(f"{n}: {e:.2e}" for n, e in
                    res["bf16_prefill_vs_forward"].items())
        + f" of max|logit| (tol {BF16_MODEL_TOL})")
    del svc, model
    torch.cuda.empty_cache()
    return res


def phase_unfused_timing():
    """`ssd_fwd` per call at the prefill's batch G=1 and at G=4, L=131072,
    bf16, and at G=1 in fp32 (the dtype of a bf16 model's prefill scan), no
    carries (as the prefill runs it), beside its plain version and bound;
    the timed outputs held against the plain version's."""
    from caduceus_tpu_torch.kernel_check import TOL
    from caduceus_tpu_torch.ops.ssd import ssd_chunked
    from caduceus_tpu_torch.ops.ssd_batched import KERNEL_CHUNK, ssd_fwd

    L, H, P, NG, N = 131072, 8, 64, 1, 128
    res = {}
    for G, dtype in ((1, torch.bfloat16), (4, torch.bfloat16),
                     (1, torch.float32)):
        T = KERNEL_CHUNK[dtype]
        es = 2 if dtype == torch.bfloat16 else 4
        inp = unfused_inputs(G, L, H, P, NG, N, dtype, 700 + G + es, pad=16)
        a = _unfused_args(inp)
        outs = {}
        t = _timed(lambda: outs.__setitem__("k", ssd_fwd(
                       *a, True, False, T, inp["h_init"], False)[:2]),
                   lambda: outs.__setitem__("p", ssd_chunked(
                       *a, True, False, T, inp["h_init"],
                       return_final_state=True)))
        dname = str(dtype)[6:]
        t["check"] = hold(f"timed ssd_fwd G={G} L={L} {dname}",
                          TOL[dtype], outs.pop("k"), outs.pop("p"),
                          ("y", "hN"), tag="ssd-unfused")
        rows = G * L
        # x, B, C, dt read once, y written once; h_init and hN fp32; in
        # fp32 the matmul work runs on the fp32 units
        t.update(_bound(rows * (H * P + 2 * NG * N + H) * es
                        + rows * H * P * es + 2 * G * H * N * P * 4,
                        rows * (2 * T * N * NG + 2 * T * P * H
                                + 4 * N * P * H),
                        BF16_FLOP_PER_S if es == 2 else FP32_FLOP_PER_S))
        res[f"G{G}" if es == 2 else f"G{G}_fp32"] = t
        log(f"[time] ssd_fwd G={G} L={L} {dname}: kernel {t['ms']:.3f} ms "
            f"(runs {', '.join(f'{v:.3f}' for v in t['kernel_ms_runs'])}), "
            f"plain {t['plain_ms']:.1f} ms, bound {t['bound_ms']:.3f} ms "
            f"({t['bound_by']}: {t['bytes'] / 1e9:.3f} GB)")
        del inp, a, outs
    return res

# --- the unfused SSD adjoint (#4 / #6), the per-head route (#5 / #6) and the
# paired v1 backward (#10) ----------------------------------------------

UNFUSED_BWD_NAMES = ("g_x", "g_dt", "g_A", "g_B", "g_C", "g_D", "g_dt_bias",
                     "g_h0")
BIDIR_BWD_NAMES = ("g_uf", "g_df", "g_Bf", "g_Cf", "g_ur", "g_dr", "g_Br",
                   "g_Cr", "g_Af", "g_Ar", "g_Df", "g_Dr", "g_biasf",
                   "g_biasr")


def unfused_bwd_pair(inp, reverse, **over):
    """`ssd_bwd` and its plain version `ssd_chunked_bwd` from the same
    carries (the forward kernel's), nonzero h_init and g_hN: the eight
    gradients of each. ``over`` replaces inputs of the kernel's run only."""
    from caduceus_tpu_torch.ops.ssd import ssd_chunked_bwd
    from caduceus_tpu_torch.ops.ssd_batched import (KERNEL_CHUNK, ssd_bwd,
                                                    ssd_fwd)

    T = KERNEL_CHUNK[inp["x"].dtype]
    a = _unfused_args(inp)
    _, _, car = ssd_fwd(*a, True, reverse, T, inp["h_init"], True)
    k = {**inp, **over}
    kernel = ssd_bwd(*_unfused_args(inp, **over), k["g_y"], car, k["g_hN"],
                     True, reverse, T)
    torch.cuda.synchronize()
    plain = ssd_chunked_bwd(*a, inp["g_y"], car, inp["g_hN"], True, reverse,
                            T)
    return kernel, plain


def phase_unfused_bwd_checks():
    """`ssd_bwd` (TPU kernels #4 / #6) against `ssd_chunked_bwd`, all eight
    gradients: small shapes (fp32 and bf16, both directions, ngroups 1 and
    2, x/B/C and dt as strided column views, L not a multiple of the
    chunk), the main geometry, and planted faults that must fail."""
    from caduceus_tpu_torch.kernel_check import TOL

    results, faults, seed = [], {}, 800
    for dtype in (torch.float32, torch.bfloat16):
        for NG in (1, 2):
            for reverse in (False, True):
                seed += 1
                inp = unfused_inputs(2, 200, 4, 32, NG, 32, dtype, seed,
                                     pad=16)
                label = (f"unfused bwd small G=2 L=200 H=4 P=32 NG={NG} N=32 "
                         f"{str(dtype)[6:]} rev={reverse}")
                results.append({"case": label, **hold(
                    label, TOL[dtype], *unfused_bwd_pair(inp, reverse),
                    UNFUSED_BWD_NAMES, tag="ssd-bwd")})
    for dtype, reverse in ((torch.bfloat16, False), (torch.bfloat16, True),
                           (torch.float32, False)):
        seed += 1
        inp = unfused_inputs(4, 8192, 8, 64, 1, 128, dtype, seed, pad=16)
        label = (f"unfused bwd main G=4 L=8192 H=8 P=64 N=128 "
                 f"{str(dtype)[6:]} rev={reverse}")
        kernel, plain = unfused_bwd_pair(inp, reverse)
        results.append({"case": label, **hold(
            label, TOL[dtype], kernel, plain, UNFUSED_BWD_NAMES,
            tag="ssd-bwd")})
        if faults:
            continue
        t0 = 37 * 64 + 16                 # rows 16..31 of chunk 37
        planted = {"g_h0 left at zero": kernel[:7] + (
            torch.zeros_like(kernel[7]),)}
        planted["g_A scaled by 1+2^-4"] = kernel[:2] + (
            kernel[2] * (1 + 2 ** -4),) + kernel[3:]
        g_dt = kernel[1].clone()
        g_dt[1, t0:t0 + 16, 5] = 0
        planted["one 16-row tile of g_dt (g1, h5) zeroed"] = (
            kernel[:1] + (g_dt,) + kernel[2:])
        g_B = kernel[3].clone()
        g_B[1, t0:t0 + 16, 0, 16:32] = 0
        planted["one 16x16 tile of g_B zeroed"] = (
            kernel[:3] + (g_B,) + kernel[4:])
        for name, out in planted.items():
            faults[name] = hold(f"planted fault: {name}", TOL[dtype], out,
                                plain, UNFUSED_BWD_NAMES, expect_ok=False,
                                tag="ssd-bwd")
        del planted, g_dt, g_B
        del inp, kernel, plain
    return results, faults


def phase_chained_grad():
    """Two chained `ssd_batched_chained` calls (the prompt split at row
    1000, inside a chunk) against one call, through autograd on the card
    (`_SSDFn`: `ssd_fwd` + `ssd_bwd`): y, hN and every gradient, g_h0
    among them, by `kernel_check.py`'s fp32 rule. The launches of this
    phase are #4's path: `ssd_batched_chained` under grad."""
    from caduceus_tpu_torch.kernel_check import TOL
    from caduceus_tpu_torch.ops.ssd_batched import ssd_batched_chained

    inp = unfused_inputs(2, 4096, 8, 64, 1, 128, torch.float32, 900)
    names = ("x", "dt", "A", "B", "C", "D", "dt_bias", "h_init")
    cut = 1000

    def run(split):
        leaves = [inp[n].detach().clone().requires_grad_() for n in names]
        x, dt, A, B, C, D, bias, h0 = leaves
        if split:
            y1, h1 = ssd_batched_chained(x[:, :cut], dt[:, :cut], A,
                                         B[:, :cut], C[:, :cut], D, bias, h0)
            y2, hN = ssd_batched_chained(x[:, cut:], dt[:, cut:], A,
                                         B[:, cut:], C[:, cut:], D, bias, h1)
            y = torch.cat([y1, y2], 1)
        else:
            y, hN = ssd_batched_chained(x, dt, A, B, C, D, bias, h0)
        loss = (y * inp["g_y"]).sum() + (hN * inp["g_hN"]).sum()
        grads = torch.autograd.grad(loss, leaves)
        return (y.detach(), hN.detach()) + grads

    _zero_counts()
    one = run(False)
    two = run(True)
    torch.cuda.synchronize()
    counts = _counts()
    want = dict.fromkeys(counts, 0)
    want.update({"ssd_fwd": 3, "ssd_bwd": 3})
    check(counts == want, f"chained gradient launches {counts} != {want}")
    res = hold(f"two chained ssd_batched_chained (split at {cut}) vs one "
               "call, G=2 L=4096 H=8 P=64 N=128 fp32", TOL[torch.float32],
               two, one, ("y", "hN") + tuple(f"g_{n}" for n in names),
               tag="ssd-chain")
    return {"checks": res, "launches": counts}


def bidir_bwd_pair(f, r, **over):
    """`bidir_scan_bwd` (one launch), the default two-launch backward
    (`selective_scan_bwd` per set) and the plain adjoints, from the paired
    forward kernel's carries: three 14-tuples in `bidir_scan_bwd_impl`'s
    order. ``over`` replaces the paired kernel's inputs of set r."""
    from caduceus_tpu_torch.ops import scan
    from caduceus_tpu_torch.ops.selective_scan import selective_scan_bwd

    T = scan.KERNEL_CHUNK
    a, b = _scan_args(f), _scan_args(r)
    _, _, carf, carr = scan.bidir_scan_fwd(*a[:2], *a[3:5], *b[:2], *b[3:5],
                                           a[2], b[2], a[5], b[5], a[6], b[6],
                                           save_carries=True)
    rk = {**r, **over}
    b_k = _scan_args(rk)
    paired = scan.bidir_scan_bwd(*a[:2], *a[3:5], *b_k[:2], *b_k[3:5], a[2],
                                 b_k[2], a[5], b_k[5], a[6], b_k[6], f["g_y"],
                                 rk["g_y"], carf, carr)
    order = lambda gf, gr: (*gf[:2], *gf[3:5], *gr[:2], *gr[3:5], gf[2],
                            gr[2], gf[5], gr[5], gf[6], gr[6])
    two = order(scan.selective_scan_bwd_cuda(*a, f["g_y"], carf, None, True,
                                             False, T),
                scan.selective_scan_bwd_cuda(*b, r["g_y"], carr, None, True,
                                             True, T))
    torch.cuda.synchronize()
    plain = order(selective_scan_bwd(*a, f["g_y"], carf, None, True, False, T),
                  selective_scan_bwd(*b, r["g_y"], carr, None, True, True, T))
    return paired, two, plain


def phase_bidir_bwd_checks():
    """`bidir_scan_bwd` (TPU kernel #10) against the two-launch backward and
    the plain adjoints: small shapes and the main geometry (d=512, N=16,
    G=4, L=8192), then planted faults that must fail."""
    from caduceus_tpu_torch.kernel_check import TOL

    res, faults, seed = [], {}, 600
    for dtype in (torch.float32, torch.bfloat16):
        seed += 1
        f = scan_inputs(2, 200, 48, 16, dtype, seed)
        r = scan_inputs(2, 200, 48, 16, dtype, seed + 50, D=False, bias=False)
        paired, two, plain = bidir_bwd_pair(f, r)
        for ref_name, ref in (("two launches", two), ("plain", plain)):
            label = (f"bidir bwd small G=2 L=200 d=48 N=16 {str(dtype)[6:]} "
                     f"vs {ref_name}")
            res.append({"case": label, **hold(label, TOL[dtype], paired, ref,
                                              BIDIR_BWD_NAMES,
                                              tag="scan-bwd")})
    dtype = torch.bfloat16
    f = scan_inputs(4, 8192, 512, 16, dtype, 650, model_like=True)
    r = scan_inputs(4, 8192, 512, 16, dtype, 651, model_like=True)
    paired, two, plain = bidir_bwd_pair(f, r)
    for ref_name, ref in (("two launches", two), ("plain", plain)):
        label = f"bidir bwd main G=4 L=8192 d=512 N=16 bf16 vs {ref_name}"
        res.append({"case": label, **hold(label, TOL[dtype], paired, ref,
                                          BIDIR_BWD_NAMES, tag="scan-bwd")})
    wrong, _, _ = bidir_bwd_pair(f, r, g_y=f["g_y"])
    faults["the reverse set given the forward set's g_y"] = hold(
        "planted fault: the reverse set given the forward set's g_y",
        TOL[dtype], wrong, plain, BIDIR_BWD_NAMES, expect_ok=False,
        tag="scan-bwd")
    g_u = paired[0].clone()
    g_u[1, 37 * 64 + 16:37 * 64 + 32, 80:96] = 0
    faults["one 16-channel tile of g_u zeroed"] = hold(
        "planted fault: one 16-row x 16-channel tile of g_uf zeroed",
        TOL[dtype], (g_u,) + paired[1:], plain, BIDIR_BWD_NAMES,
        expect_ok=False, tag="scan-bwd")
    return res, faults


def phase_head_serve():
    """Serve the full-width 16-layer `use_kernel: pallas` model: /logits at
    bucket 1024 and one 131,072-token /logits; 32 `ssd_head_fwd` launches
    (TPU kernel #5) per dispatch and no other kernel; the served logits
    equal a direct forward."""
    from caduceus_tpu_torch.models.caduceus import CaduceusForMaskedLM
    from caduceus_tpu_torch.serve import InferenceServer, InferenceService

    cfg = hg38_mlm_v2_pallas_config()
    model = CaduceusForMaskedLM(
        cfg, device="cpu", generator=torch.Generator().manual_seed(4444))
    svc = InferenceService(cfg, model.state_dict(), device="cuda",
                           max_batch=4, min_bucket=1024, max_length=131072)
    del model
    server = InferenceServer(svc, port=0).start()
    rng = np.random.default_rng(10)
    plan = [["".join(rng.choice(list("ACGT"), n)) for n in lengths]
            for lengths in ((900, 1024), (131072,))]
    requests = []
    try:
        torch.cuda.reset_peak_memory_stats()
        d0 = svc.n_dispatches
        _zero_counts()
        outs = []
        for batch in plan:
            t0 = time.perf_counter()
            out = _post(server.port, "/logits", {"sequences": batch})["logits"]
            dt = time.perf_counter() - t0
            ntok = sum(map(len, batch))
            for s_, o in zip(batch, out):
                a = np.asarray(o, np.float32)
                check(a.shape == (len(s_), cfg.padded_vocab_size),
                      f"/logits: shape {a.shape}")
                check(bool(np.isfinite(a).all()), "/logits: non-finite")
            outs.append(out)
            requests.append({"n_seq": len(batch), "tokens": ntok,
                             "latency_s": dt, "tokens_per_s": ntok / dt})
            log(f"[serve-head] /logits {len(batch)} seq, {ntok} tokens: "
                f"{dt * 1e3:.1f} ms, {ntok / dt:,.0f} tokens/s")
        counts = _counts()
        dispatches = svc.n_dispatches - d0
        peak = torch.cuda.max_memory_allocated()
    finally:
        server.stop()
    check(dispatches == len(plan), f"{dispatches} dispatches for "
          f"{len(plan)} requests")
    want = dict.fromkeys(counts, 0)
    want["ssd_head_fwd"] = 2 * cfg.n_layer * dispatches
    check(counts == want, f"per-head serve launches {counts} != {want}")
    batch, out = plan[0], outs[0]
    ids = torch.full((2, 1024), svc.tok.pad_token_id, dtype=torch.long)
    for i, s_ in enumerate(batch):
        ids[i, :len(s_)] = torch.from_numpy(
            svc.tok.encode(s_).astype(np.int64))
    with torch.inference_mode():
        direct = svc.model(ids.cuda()).cpu().numpy()
    for i, s_ in enumerate(batch):
        err = np.abs(np.asarray(out[i], np.float32)
                     - direct[i, :len(s_)]).max()
        check(err <= 1e-6, f"served per-head /logits differ from the model "
              f"by {err}")
    long_ids = torch.from_numpy(
        svc.tok.encode(plan[-1][0]).astype(np.int64))[None].cuda()
    with torch.inference_mode():
        svc.model(long_ids)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc.model(long_ids)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
    log(f"[serve-head] ssd_head_fwd launches {counts['ssd_head_fwd']} over "
        f"{dispatches} dispatches (= {2 * cfg.n_layer} each); served logits "
        f"equal a direct forward; direct forward 1 x 131072 (no HTTP/JSON) "
        f"{fwd_s * 1e3:.1f} ms; peak memory {peak / 2**30:.2f} GiB")
    del svc
    torch.cuda.empty_cache()
    return {"requests": requests, "launches": counts["ssd_head_fwd"],
            "dispatches": dispatches, "peak_mem_bytes": peak,
            "forward_131k_s": fwd_s}


def phase_new_timing():
    """At the training shape (G=4, L=131072, bf16, forward direction): the
    per-head forward `ssd_head_fwd` (#5, with carries), the unfused adjoint
    through `ssd_bwd` (#4) and through `ssd_head_bwd` (#6; one kernel, each
    entry timed and held on its own), and the paired scan adjoint
    `bidir_scan_bwd` (#10), each beside its plain version and bound; the
    timed outputs held against the plain ones."""
    from caduceus_tpu_torch.kernel_check import TOL
    from caduceus_tpu_torch.ops import scan, ssd_head
    from caduceus_tpu_torch.ops import selective_scan as plain_scan
    from caduceus_tpu_torch.ops.ssd import ssd_chunked, ssd_chunked_bwd
    from caduceus_tpu_torch.ops.ssd_batched import KERNEL_CHUNK, ssd_bwd

    bf16 = TOL[torch.bfloat16]
    G, L, H, P, NG, N = 4, 131072, 8, 64, 1, 128
    T = KERNEL_CHUNK[torch.bfloat16]
    rows, nc = G * L, -(-L // T)
    res = {}
    inp = unfused_inputs(G, L, H, P, NG, N, torch.bfloat16, 990, pad=16)
    a = _unfused_args(inp)
    outs = {}
    t = _timed(lambda: outs.__setitem__("k", ssd_head.ssd_head_fwd(
                   *a, True, False, T, None, True)),
               lambda: outs.__setitem__("p", ssd_chunked(
                   *a, True, False, T, None, return_carries=True)))
    k, p_ = outs.pop("k"), outs.pop("p")
    t["check"] = hold(f"timed ssd_head_fwd + carries G=4 L={L} bf16", bf16,
                      k, p_, tag="ssd-head")
    car = k[2]
    del k, p_
    car_bytes = G * nc * H * N * P * 2
    # x, B, C, dt read, y and the carries written (bf16); hN fp32
    t.update(_bound(rows * (H * P + 2 * NG * N + H) * 2 + rows * H * P * 2
                    + car_bytes + G * H * N * P * 4,
                    rows * (2 * T * N * NG + 2 * T * P * H + 4 * N * P * H)))
    res["head_fwd"] = t

    bwd_args = a + [inp["g_y"], car, None, True, False, T]
    t = _timed(lambda: outs.__setitem__("k", ssd_bwd(*bwd_args)),
               lambda: outs.__setitem__("p", ssd_chunked_bwd(*bwd_args)))
    t["check"] = hold(f"timed ssd_bwd G=4 L={L} bf16", bf16, outs.pop("k"),
                      outs.pop("p"), UNFUSED_BWD_NAMES, tag="ssd-bwd")
    # reads x, B, C, dt, g_y and the carries; writes g_x, g_dt, g_B, g_C
    # in their inputs' dtype (bf16: the TPU kernels' out_shape; the card's
    # fp32 sums of g_B / g_C are its own design) and g_h0 (fp32); the
    # matmul work of the fused backward's SSD part
    bwd_bound = _bound(rows * ((H * P + 2 * NG * N + H) * 2 + H * P * 2)
                       + car_bytes + rows * (H * P + H + 2 * NG * N) * 2
                       + G * H * N * P * 4,
                       rows * (6 * T * N * NG + H * (4 * T * P + 12 * N * P)))
    t.update(bwd_bound)
    res["unfused_bwd"] = t
    # the per-head entry (#6) on the same inputs, timed and held on its own
    t = _timed(lambda: outs.__setitem__("k", ssd_head.ssd_head_bwd(
                   *bwd_args)),
               lambda: outs.__setitem__("p", ssd_chunked_bwd(*bwd_args)))
    t["check"] = hold(f"timed ssd_head_bwd G=4 L={L} bf16", bf16,
                      outs.pop("k"), outs.pop("p"), UNFUSED_BWD_NAMES,
                      tag="ssd-head")
    t.update(bwd_bound)
    res["head_bwd"] = t
    del inp, a, car, bwd_args

    # the paired scan adjoint, v1 geometry
    d, Ns = 512, 16
    Ts = scan.KERNEL_CHUNK
    ncs = -(-L // Ts)
    f = scan_inputs(G, L, d, Ns, torch.bfloat16, 991, model_like=True)
    r = scan_inputs(G, L, d, Ns, torch.bfloat16, 992, model_like=True)
    fa, ra = _scan_args(f), _scan_args(r)
    _, _, carf, carr = scan.bidir_scan_fwd(*fa[:2], *fa[3:5], *ra[:2],
                                           *ra[3:5], fa[2], ra[2], fa[5],
                                           ra[5], fa[6], ra[6],
                                           save_carries=True)
    pargs = (*fa[:2], *fa[3:5], *ra[:2], *ra[3:5], fa[2], ra[2], fa[5], ra[5],
             fa[6], ra[6], f["g_y"], r["g_y"], carf, carr)

    def plain_pair():
        gf = plain_scan.selective_scan_bwd(*fa, f["g_y"], carf, None, True,
                                           False, Ts)
        gr = plain_scan.selective_scan_bwd(*ra, r["g_y"], carr, None, True,
                                           True, Ts)
        return (*gf[:2], *gf[3:5], *gr[:2], *gr[3:5], gf[2], gr[2], gf[5],
                gr[5], gf[6], gr[6])

    t = _timed(lambda: outs.__setitem__("k", scan.bidir_scan_bwd(*pargs)),
               lambda: outs.__setitem__("p", plain_pair()))
    t["check"] = hold(f"timed bidir_scan_bwd G=4 L={L} bf16", bf16,
                      outs.pop("k"), outs.pop("p"), BIDIR_BWD_NAMES,
                      tag="scan-bwd")
    # twice #8's bytes and operations: per set u, delta, g_y, B, C and the
    # carries read, g_u, g_delta, g_B, g_C written
    t.update(_bound(2 * (rows * (3 * d * 2 + 2 * Ns * 2 + 2 * d * 2
                                 + 2 * Ns * 2) + G * ncs * d * Ns * 4),
                    2 * 20 * rows * d * Ns, FP32_FLOP_PER_S))
    t["two_launch_ms"] = _time_cuda(lambda: (
        scan.selective_scan_bwd_cuda(*fa, f["g_y"], carf, None, True, False,
                                     Ts),
        scan.selective_scan_bwd_cuda(*ra, r["g_y"], carr, None, True, True,
                                     Ts)), 3)
    # per set, as #8: the fp32 g_B / g_C shares written and read again
    t["extra_bytes"] = 2 * 2 * scan.n_bc_shares(d) * 2 * rows * Ns * 4
    t["exps"] = 2 * (rows * d * Ns + rows * d)
    res["bidir_bwd"] = t
    for name, t in res.items():
        log(f"[time] {name} G=4 L={L} bf16: kernel {t['ms']:.3f} ms (runs "
            f"{', '.join(f'{v:.3f}' for v in t['kernel_ms_runs'])}), plain "
            f"{t['plain_ms']:.1f} ms, bound {t['bound_ms']:.3f} ms "
            f"({t['bound_by']}: {t['bytes'] / 1e9:.3f} GB, "
            f"{t['flops'] / 1e12:.3f} TFLOP)"
            + (f"; the default two launches of selective_scan_bwd "
               f"{t['two_launch_ms']:.3f} ms" if "two_launch_ms" in t else ""))
    return res


# -- pretraining through the port's own loop (cli.py pretrain) --------------

PRETRAIN_L, PRETRAIN_BATCH, PRETRAIN_ACCUM = 131072, 4, 2
# 8 of hg38_mlm_v2's 16 layers (the depth of [train], whose step is the
# bare step the loop is held against); run A is also the model of the
# downstream phases
PRETRAIN_LAYERS = 8
# synthetic hg38 stand-in: 2 contigs of 2^23 bases cut into the production
# window of 2^20 (train, valid and test rows)
GENOME_CONTIGS, GENOME_CONTIG_LEN, GENOME_WINDOW = 2, 1 << 23, 1 << 20


def _pretrain_argv(fasta, bed, config_path, run_dir):
    return ["pretrain", "--fasta", fasta, "--bed", bed,
            "--config-path", config_path, "--run-dir", run_dir,
            "--max-length", str(PRETRAIN_L),
            "--batch-size", str(PRETRAIN_BATCH),
            "--accum-steps", str(PRETRAIN_ACCUM), "--max-steps", "4",
            "--checkpoint-every", "2", "--log-every", "1", "--eval-every", "4",
            "--eval-batches", "1", "--ema-decay", "0.999"]


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    steps = {r["step"]: r for r in rows if "loss" in r}
    evals = [r for r in rows if "val/loss" in r and "step" not in r]
    return steps, evals


def _run_cli(argv, log_path, kill_when=None):
    """`python -m caduceus_tpu_torch.cli` in a subprocess from the checkout
    (output to ``log_path``); with ``kill_when``, SIGKILL it as soon as that
    path exists. Returns the exit code."""
    root = os.path.dirname(os.path.abspath(__file__))
    with open(log_path, "ab") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "caduceus_tpu_torch.cli", *argv],
            cwd=root, stdout=out, stderr=subprocess.STDOUT)
        try:
            while proc.poll() is None:
                if kill_when is not None and os.path.exists(kill_when):
                    proc.kill()
                    break
                time.sleep(0.02)
            return proc.wait(timeout=1800)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _tail(path, n=40):
    with open(path, errors="replace") as f:
        return "".join(f.readlines()[-n:])


def phase_pretrain(workdir, fasta, bed, config, n_layer):
    """Pretrain through `cli.py pretrain` (the port's data loader, `Trainer`,
    checkpoints): run A in this process (launches counted) with the Python
    loader; run B, the same command with the native loader in a
    subprocess, SIGKILLed as soon as its step-2 checkpoint is in place and
    rerun with ``--resume``. B's steps (1-2 before the kill, 3-4 after it)
    must log A's loss, acc, grad_norm and lr, and the two runs end with
    the same parameters, EMA and eval record, bit for bit."""
    from caduceus_tpu_torch import cli
    from caduceus_tpu_torch.train import checkpoint

    name = config.__name__[:-7]
    cfg = config(n_layer=n_layer)
    cfg_path = os.path.join(workdir, f"{name}_{n_layer}.json")
    cfg.save(cfg_path)
    run_a = os.path.join(workdir, f"{name}_a")
    run_b = os.path.join(workdir, f"{name}_b")
    torch.cuda.empty_cache()
    _zero_counts()
    t0 = time.perf_counter()
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        cli.main(_pretrain_argv(fasta, bed, cfg_path, run_a))
    a_s = time.perf_counter() - t0
    counts = _counts()
    gc.collect()   # run A's model and optimizer, before B takes the card
    torch.cuda.empty_cache()
    n_mb = 4 * PRETRAIN_ACCUM
    want = {k: v * n_mb for k, v in _per_micro_batch(cfg).items()}
    # the eval at step 4: one batch through the weights and one through the
    # EMA, each forward one scan launch per direction and layer
    fwd = "ssd_fused_fwd" if cfg.ssm_cfg.version == 2 else "bidir_scan_fwd"
    want[fwd] += 2 * (2 if cfg.ssm_cfg.version == 2 else 1) * n_layer
    check(counts == want, f"pretrain {name}: launches {counts} != {want}")

    log_b = os.path.join(workdir, f"{name}_b.log")
    argv_b = _pretrain_argv(fasta, bed, cfg_path, run_b) + [
        "--use-native-loader"]
    ck_b = os.path.join(run_b, "checkpoints")
    t0 = time.perf_counter()
    rc = _run_cli(argv_b, log_b,
                  kill_when=os.path.join(ck_b, "2", "meta.json"))
    b1_s = time.perf_counter() - t0
    check(rc == -9, f"run B was not killed (exit {rc}):\n{_tail(log_b)}")
    check(checkpoint.latest_step(ck_b) == 2,
          f"run B killed at step {checkpoint.latest_step(ck_b)}, not 2")
    t0 = time.perf_counter()
    rc = _run_cli(argv_b + ["--resume"], log_b)
    b2_s = time.perf_counter() - t0
    check(rc == 0, f"resumed run B failed ({rc}):\n{_tail(log_b)}")

    steps_a, evals_a = _records(run_a)
    steps_b, evals_b = _records(run_b)
    check(sorted(steps_a) == sorted(steps_b) == [1, 2, 3, 4],
          f"logged steps A {sorted(steps_a)}, B {sorted(steps_b)}")
    for s in (1, 2, 3, 4):
        for k in ("loss", "acc", "grad_norm", "lr"):
            check(steps_a[s][k] == steps_b[s][k],
                  f"{name} step {s} {k}: A {steps_a[s][k]!r} != B "
                  f"{steps_b[s][k]!r}")
        check(math.isfinite(steps_a[s]["loss"]), f"step {s}: loss not finite")
    check(len(evals_a) == len(evals_b) == 1 and evals_a == evals_b,
          f"eval records differ: A {evals_a}, B {evals_b}")
    for f in ("params.npz", "ema_params.npz"):
        za = np.load(os.path.join(run_a, "checkpoints", "4", f))
        zb = np.load(os.path.join(run_b, "checkpoints", "4", f))
        check(sorted(za.files) == sorted(zb.files), f"{f}: keys differ")
        for k in za.files:
            check(np.array_equal(za[k], zb[k]), f"{f} {k}: A != B")

    tokens = PRETRAIN_BATCH * PRETRAIN_L
    step_s = {s: tokens / r["tokens_per_sec"] for s, r in steps_a.items()}
    # steps 2 and 4: no warm-up, checkpoint or eval inside their interval
    loop_s = (step_s[2] + step_s[4]) / 2
    log(f"[pretrain] {name}, {n_layer} layers, L={PRETRAIN_L}, "
        f"{PRETRAIN_BATCH} sequences in {PRETRAIN_ACCUM} micro-batches: run "
        f"A (Python loader, in process) {a_s:.1f} s for 4 steps, seconds "
        f"per logged step {', '.join(f'{step_s[s]:.3f}' for s in (1, 2, 3, 4))}"
        f" (loop step {loop_s:.3f} s, {tokens / loop_s:,.0f} tokens/s); run B "
        f"(native loader, subprocess) killed after its step-2 checkpoint "
        f"({b1_s:.1f} s) and resumed ({b2_s:.1f} s): steps 1-4 and the eval "
        f"equal A's bit for bit, params and EMA at step 4 equal; launches "
        f"{counts}; eval {evals_a[0]}")
    return {"n_layer": n_layer, "step_s": step_s, "loop_step_s": loop_s,
            "loop_tokens_per_s": tokens / loop_s, "run_a_s": a_s,
            "run_b_killed_s": b1_s, "run_b_resumed_s": b2_s,
            "launches": counts, "eval": evals_a[0],
            "steps": {s: {k: r[k] for k in ("loss", "acc", "grad_norm", "lr")}
                      for s, r in steps_a.items()},
            "run_a": run_a}


def phase_loader_timing(fasta, bed, n=6):
    """ms per batch of 4 x 131,072 tokens from the Python and the native
    loader (MLM, shuffled train windows), the first batch left out."""
    from caduceus_tpu_torch.data.hg38 import HG38DataModule

    out = {}
    for native in (False, True):
        dm = HG38DataModule(bed, fasta, max_length=PRETRAIN_L,
                            batch_size=PRETRAIN_BATCH, seed=1,
                            use_native=native)
        loader = dm.train_loader()
        try:
            it = iter(loader)
            next(it)
            t0 = time.perf_counter()
            for _ in range(n - 1):
                b = next(it)
            ms = (time.perf_counter() - t0) / (n - 1) * 1e3
        finally:
            loader.close()
        check(b["input_ids"].shape == (PRETRAIN_BATCH, PRETRAIN_L),
              f"loader batch {b['input_ids'].shape}")
        out["native" if native else "python"] = ms
    log(f"[pretrain] loader, batch of {PRETRAIN_BATCH} x {PRETRAIN_L} "
        f"(MLM): Python {out['python']:.1f} ms, native {out['native']:.1f} ms "
        f"(host, {os.cpu_count()} cores)")
    return out


def phase_pretrain_reads(run_a, fasta, bed):
    """`cli.py eval` of run A's test split on the card, and run A (no
    params.npz, only checkpoints) served: a 1,024-token /logits equals a
    direct forward of its latest EMA weights."""
    import io

    from caduceus_tpu_torch import cli
    from caduceus_tpu_torch.models.caduceus import CaduceusForMaskedLM
    from caduceus_tpu_torch.params import from_jax_params
    from caduceus_tpu_torch.serve import InferenceServer, InferenceService
    from caduceus_tpu_torch.train.checkpoint import read_latest_params

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["eval", "--fasta", fasta, "--bed", bed, "--run-dir", run_a,
                  "--split", "test", "--max-length", str(PRETRAIN_L),
                  "--batch-size", str(PRETRAIN_BATCH), "--max-batches", "1"])
    ev = json.loads(buf.getvalue().strip().splitlines()[-1])
    check(set(ev) == {"test/loss", "test/acc", "test/ppl"}
          and all(math.isfinite(v) for v in ev.values()),
          f"cli eval: {ev}")
    check(not os.path.exists(os.path.join(run_a, "params.npz")),
          "run A has a params.npz export")
    svc = InferenceService.from_run_dir(run_a, device="cuda", max_batch=1,
                                        min_bucket=1024, max_length=1024)
    server = InferenceServer(svc, port=0).start()
    seq = "".join(np.random.default_rng(3).choice(list("ACGT"), 1024))
    try:
        served = np.asarray(_post(server.port, "/logits",
                                  {"sequences": [seq]})["logits"][0],
                            np.float32)
    finally:
        server.stop()
    flat, step = read_latest_params(run_a)
    model = CaduceusForMaskedLM(svc.cfg, device="cuda")
    model.load_state_dict(from_jax_params(flat, svc.cfg))
    ids = torch.from_numpy(svc.tok.encode(seq).astype(np.int64))[None].cuda()
    with torch.inference_mode():
        direct = model(ids)[0].cpu().numpy()
    err = float(np.abs(served - direct).max())
    check(served.shape == direct.shape and err <= 1e-6,
          f"served /logits of the checkpoint differ from a direct forward "
          f"by {err}")
    del model, svc
    torch.cuda.empty_cache()
    log(f"[pretrain] cli eval of run A, test split, 1 batch: {ev}; run A "
        f"served from checkpoints/{step} (EMA): /logits of 1,024 tokens "
        f"equal a direct forward (max |diff| {err:.1e})")
    return {"eval": ev, "serve_max_abs_err": err, "served_step": step}


# -- fine-tuning, /classify and VEP downstream of run A ----------------------

FT_TASK = "human_nontata_promoters"
FT_PRESET = os.path.join("configs", "downstream", "gb", f"{FT_TASK}.yaml")
FT_L, FT_BATCH = 251, 128          # the preset's geometry
FT_G = 2 * FT_BATCH                # both strands per kernel call (RCPS)
FT_TRAIN, FT_TEST = 1138, 256      # 1,024 training sequences after the split
# seed -> the outputs of #3a + #3b that miss the rule with h_init and g_hN at
# the fine-tuning shape (ROADMAP.md queue 3 item 7; held as expected misses,
# as tests/test_torch_cuda.py FT_GHN_KNOWN_MISSES holds them)
FT_GHN_KNOWN_MISSES = {701: ("g_dt_bias",)}
# the same at the CP shape with g_y = 0, as pass 1 of the two-pass scan gives
# the adjoint (ROADMAP.md queue 3 item 12): the gradient reaches only the
# last rows, so g_xBC and g_dt are zero almost everywhere (mean|ref| ~1e-4 of
# max), and g_A / g_dt_bias cancel; kernel and plain version alike are
# 0.3-24% (rel_l2) from the float64 value there
CP_GHN_KNOWN_MISSES = {760: ("g_xBC", "g_dt", "g_A", "g_dt_bias"),
                       761: ("g_xBC", "g_dt")}
# "as near as the plain version": within 1% of its distance from the
# float64 value (the two bf16 orders differ from each other by ~1e-4 there
# while each is ~3e-3 from float64)
AS_NEAR = 1.01
VEP_L, VEP_BATCH, VEP_N = 131072, 2, 16
CLASSIFY_BURSTS = 30               # bursts of 8 concurrent /classify requests


def phase_finetune_kernels():
    """#1 + #3a/#3b and #9 + #8 at the fine-tuning shape: G=256 (128
    sequences x 2 strands), L=251, full width, bf16, both directions,
    against their plain versions (the forwards from a nonzero h_init; the
    SSD adjoint as the fine-tuning step runs it, without h_init and g_hN,
    and with both, where `FT_GHN_KNOWN_MISSES` must miss and the plain
    version on the CPU is compared with the plain version on the card; the
    scan adjoint with both); then each kernel timed as the step calls it
    (forward direction) beside its plain version and its bound at that
    shape."""
    from caduceus_tpu_torch.kernel_check import TOL
    from caduceus_tpu_torch.ops import scan
    from caduceus_tpu_torch.ops import selective_scan as plain_scan
    from caduceus_tpu_torch.ops import ssd as plain_ssd
    from caduceus_tpu_torch.ops import ssd_batched as sb

    G, L = FT_G, FT_L
    H, P, NG, N, K = 8, 64, 1, 128, 4
    T = sb.KERNEL_CHUNK[torch.bfloat16]
    bf16 = TOL[torch.bfloat16]
    nc = -(-L // T)
    S = sb.n_segments(G, H, nc, "cuda")
    res = {"checks": {}, "timing": {}, "segments": S}
    shape = f"G={G} L={L} bf16"
    for reverse in (False, True):
        inp = ssd_inputs(G, L, H, P, NG, N, K, torch.bfloat16, 700 + reverse,
                         width_pad=512)
        res["checks"][f"ssd_fwd rev={reverse}"] = hold(
            f"[finetune] fwd {shape} rev={reverse}", bf16,
            *run_pair(inp, reverse))
        kernel, plain, _ = bwd_pair(dict(inp, h_init=None, g_hN=None),
                                    reverse)
        res["checks"][f"ssd_bwd rev={reverse}"] = hold(
            f"[finetune] bwd (#3a + #3b) {shape} rev={reverse}", bf16,
            kernel[:-1], plain[:-1], BWD_NAMES[:-1], tag="bwd")
        del kernel, plain
        res["checks"][f"ssd_bwd g_hN rev={reverse}"] = _hold_ghn(
            inp, reverse, 700 + reverse, f"{shape} rev={reverse}")
        del inp
        f = scan_inputs(G, L, 512, 16, torch.bfloat16, 710 + reverse,
                        model_like=True)
        r = scan_inputs(G, L, 512, 16, torch.bfloat16, 720 + reverse,
                        model_like=True)
        res["checks"][f"bidir_scan_fwd rev={reverse}"] = hold(
            f"[finetune] bidir_scan_fwd {shape}", bf16,
            *(bidir_pair(r, f) if reverse else bidir_pair(f, r)),
            ("yf", "carf", "yr", "carr"), tag="scan")
        res["checks"][f"selective_scan_bwd rev={reverse}"] = hold(
            f"[finetune] selective_scan_bwd {shape} rev={reverse}", bf16,
            *scan_bwd_pair(f, reverse), SCAN_BWD_NAMES, tag="scan-bwd")
        del f, r

    # timed as the step calls them
    inp = ssd_inputs(G, L, H, P, NG, N, K, torch.bfloat16, 730, width_pad=512)
    a7 = (inp["xBC"], inp["dt"], inp["A"], inp["conv_w"], inp["conv_b"],
          inp["D"], inp["dt_bias"])
    outs = {}
    tm = res["timing"]
    tm["ssd_fused_fwd"] = _timed(
        lambda: outs.__setitem__("car", sb.ssd_fused_fwd(
            *a7, inp["dims"], True, False, T, None, save_carries=True)[2]),
        lambda: plain_ssd.ssd_chunked_fused(
            *a7, dims=inp["dims"], dt_softplus=True, chunk_size=T,
            return_carries=True), n_kernel=10)
    bwd_args = a7 + (inp["g_y"], outs["car"], None, inp["dims"], True, False,
                     T)
    tm["ssd_fused_bwd_kernel"] = _timed(
        lambda: outs.__setitem__("adj", sb.ssd_adjoint_xc(*bwd_args)),
        lambda: plain_ssd.ssd_adjoint_xc(*bwd_args), n_kernel=10)
    conv_args = (outs["adj"][0], inp["xBC"], inp["conv_w"], inp["conv_b"],
                 False)
    tm["ssd_conv_bwd_kernel"] = _timed(
        lambda: sb.conv_silu_bwd(*conv_args),
        lambda: plain_ssd.conv_silu_bwd(*conv_args), n_kernel=10)
    for k, b in _ssd_bounds(G, L, H, P, NG, N, K, T).items():
        tm[k].update(b)
    del inp, a7, bwd_args, conv_args, outs
    f = scan_inputs(G, L, 512, 16, torch.bfloat16, 740, model_like=True)
    r = scan_inputs(G, L, 512, 16, torch.bfloat16, 741, model_like=True)
    a, b = _scan_args(f), _scan_args(r)
    Ts = scan.KERNEL_CHUNK
    outs = {}
    tm["bidir_scan_fwd"] = _timed(
        lambda: outs.__setitem__("k", scan.bidir_scan_fwd(
            *a[:2], *a[3:5], *b[:2], *b[3:5], a[2], b[2], a[5], b[5], a[6],
            b[6], save_carries=True)),
        lambda: (plain_scan.selective_scan(*a, True, False, Ts,
                                           return_carries=True),
                 plain_scan.selective_scan(*b, True, True, Ts,
                                           return_carries=True)),
        n_kernel=10)
    bwd_args = a + [f["g_y"], outs["k"][2], None, True, False, Ts]
    tm["selective_scan_bwd"] = _timed(
        lambda: scan.selective_scan_bwd_cuda(*bwd_args),
        lambda: plain_scan.selective_scan_bwd(*bwd_args), n_kernel=10)
    for k, bd in _scan_bounds(G, L, 512, 16, Ts).items():
        tm[k].update(bd)
    del f, r, a, b, bwd_args, outs
    for k, t in tm.items():
        log(f"[finetune] {k} {shape}: kernel {t['ms']:.3f} ms (runs "
            f"{', '.join(f'{v:.3f}' for v in t['kernel_ms_runs'])}), plain "
            f"{t['plain_ms']:.1f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}: {t['bytes'] / 1e6:.1f} MB, "
            f"{t['flops'] / 1e9:.2f} GFLOP)")
    log(f"[finetune] SSD segments per (g, h) at {shape}: {S} ({nc} chunks "
        f"of {T} rows, the last {L - (nc - 1) * T})")
    torch.cuda.empty_cache()
    return res


def _hold_ghn(inp, reverse, seed, shape, misses=None, on_cpu=True):
    """#3a + #3b with h_init and a nonzero g_hN against the plain version:
    each output passes the rule but the seed's known misses (``misses``,
    `FT_GHN_KNOWN_MISSES` by default), which must fail it. Where one is
    known, the plain version is also run on the CPU (``on_cpu``) and
    compared with the plain version on the card and with the kernel, and
    each miss is held against its float64 value (`_exact_grads`): the
    kernel must be as near to it as the plain version (`AS_NEAR`), or
    nearer."""
    from caduceus_tpu_torch.kernel_check import TOL, compare, describe
    from caduceus_tpu_torch.ops.ssd import ssd_chunked_fused_bwd
    from caduceus_tpu_torch.ops.ssd_batched import KERNEL_CHUNK

    bf16 = TOL[torch.bfloat16]
    miss = (FT_GHN_KNOWN_MISSES if misses is None else misses).get(seed, ())
    kernel, plain, car = bwd_pair(inp, reverse)
    keep = [i for i, n in enumerate(BWD_NAMES) if n not in miss]
    out = hold(f"[finetune] bwd (#3a + #3b) with h_init and g_hN {shape}",
               bf16, [kernel[i] for i in keep], [plain[i] for i in keep],
               [BWD_NAMES[i] for i in keep], tag="bwd")
    for name in miss:
        i = BWD_NAMES.index(name)
        out[name] = hold(
            f"[finetune] bwd (#3a + #3b) with h_init and g_hN {shape} seed "
            f"{seed}, {name}: known miss (ROADMAP.md queue 3)", bf16,
            [kernel[i]], [plain[i]], [name], expect_ok=False,
            tag="bwd")[name]
    cpu = None
    if miss and on_cpu:
        cpu = ssd_chunked_fused_bwd(
            *(inp[k].cpu() for k in ("xBC", "dt", "A", "conv_w", "conv_b",
                                     "D", "dt_bias", "g_y")),
            car.cpu(), inp["g_hN"].cpu(), inp["dims"], True, reverse,
            KERNEL_CHUNK[torch.bfloat16])
        for name, k, p, c in zip(BWD_NAMES, kernel, plain, cpu):
            vs_card = compare(c, p.cpu(), bf16)
            vs_kernel = compare(k.cpu(), c, bf16)
            out[f"{name} plain cpu vs card"] = vs_card
            out[f"{name} kernel vs plain cpu"] = vs_kernel
            log(f"[bwd]   {name}: plain on the CPU vs on the card "
                f"{describe(vs_card)}; kernel vs plain on the CPU "
                f"{describe(vs_kernel)}")
    if miss:
        exact = _exact_grads(inp, reverse)
        for name in miss:
            i = BWD_NAMES.index(name)
            ex = exact[name].float().cpu()
            d = {"kernel": compare(kernel[i].cpu(), ex, bf16),
                 "plain_card": compare(plain[i].cpu(), ex, bf16)}
            if cpu is not None:
                d["plain_cpu"] = compare(cpu[i], ex, bf16)
            out[f"{name} vs float64"] = d
            log(f"[bwd]   {name} against the exact float64 gradient of the "
                f"same bf16-rounded inputs: " + "; ".join(
                    f"{k} {describe(v)}" for k, v in d.items()))
            # the known miss stays explained while the kernel is as near
            check(d["kernel"]["rel_l2"] <= AS_NEAR * min(
                v["rel_l2"] for k, v in d.items() if k != "kernel"),
                  f"{name}: the kernel is farther from the float64 value "
                  "than the plain version")
    return out


def _exact_grads(inp, reverse):
    """The gradients of sum(y g_y) + sum(hN g_hN) of the fused SSD at the
    kernel's inputs (the bf16 values as they are, the fp32 parameters),
    evaluated in float64 with no rounding between the operations: the conv
    + SiLU, then the quadratic (whole-sequence) form of the scan, per
    (g, head), y_t = exp(cum_t) C_t h0 + sum_{s<=t} (C_t . B_s)
    exp(cum_t - cum_s) dt_s x_s + D x_t and its final state; autograd
    differentiates it. For the float64 evaluation of ROADMAP.md queue 3
    item 7: which of two bf16 orders is nearer the exact sum. Returns
    {BWD_NAMES name: float64 gradient}."""
    from caduceus_tpu_torch.ops.conv import causal_conv1d

    H, P, NG, N = inp["dims"]
    f64 = lambda k: inp[k].detach().double().clone().requires_grad_(True)
    names = ("xBC", "dt", "A", "conv_w", "conv_b", "D", "dt_bias")
    t = {k: f64(k) for k in names}
    h0 = inp["h_init"].detach().double()
    G, L, _ = t["xBC"].shape
    xc = causal_conv1d(t["xBC"], t["conv_w"], t["conv_b"], "silu", reverse)
    x = xc[..., :H * P].reshape(G, L, H, P)
    B = xc[..., H * P:H * P + N]                # ngroups 1
    C = xc[..., H * P + NG * N:H * P + NG * N + N]
    dt = torch.nn.functional.softplus(t["dt"] + t["dt_bias"])
    if reverse:   # the right-to-left scan as a left-to-right one, flipped
        x, B, C, dt = (v.flip(1) for v in (x, B, C, dt))
    cum = torch.cumsum(dt * t["A"], 1)                            # (G, L, H)
    wN = torch.exp(cum[:, -1:, :] - cum) * dt                     # (G, s, H)
    hN = (torch.exp(cum[:, -1])[..., None, None] * h0
          + torch.einsum("gsh,gsn,gshp->ghnp", wN, B, x))
    loss = (hN * inp["g_hN"].double()).sum()
    if bool(inp["g_y"].any()):
        # y's share (none when g_y = 0, as in pass 1 of the two-pass scan;
        # the rest is linear in L, so it fits at the CP shape)
        keep = torch.ones(L, L, dtype=torch.bool, device=cum.device).tril()
        seg = cum[:, :, None, :] - cum[:, None, :, :]             # (G, t, s, H)
        seg = torch.where(keep[None, :, :, None], seg,
                          torch.full_like(seg, -math.inf))
        W = (torch.exp(seg) * torch.einsum("gtn,gsn->gts", C, B)[..., None]
             * dt[:, None, :, :])
        y = (torch.einsum("gtsh,gshp->gthp", W, x)
             + torch.exp(cum)[..., None]
             * torch.einsum("gtn,ghnp->gthp", C, h0)
             + t["D"][None, None, :, None] * x)
        if reverse:
            y = y.flip(1)
        loss = loss + (y * inp["g_y"].double()).sum()
        del W, seg, y
    grads = torch.autograd.grad(loss, [t[k] for k in names],
                                allow_unused=True)
    out = {n: torch.zeros_like(t[k]) if g is None else g for n, k, g in zip(
        ("g_xBC", "g_dt", "g_A", "g_conv_w", "g_conv_b", "g_D", "g_dt_bias"),
        names, grads)}
    del loss, hN, wN, cum
    torch.cuda.empty_cache()
    return out


def _finetune_argv(data_dir, run_dir, epochs, seeds, save_dir=None):
    argv = ["finetune", "--preset", FT_PRESET, "--data-dir", data_dir,
            "--pretrained-run-dir", run_dir, "--epochs", str(epochs),
            "--seeds", *[str(s) for s in seeds]]
    return argv + (["--save-dir", save_dir] if save_dir else [])


def _finetune_dm(data_dir, seed):
    from caduceus_tpu_torch.data.classification import (
        ClassificationDataModule)

    return ClassificationDataModule(data_dir, FT_TASK, max_length=FT_L,
                                    batch_size=FT_BATCH,
                                    train_val_split_seed=seed, seed=seed)


def phase_finetune(data_dir, run_dir, name, n_layer, epochs, seeds,
                   save_dir=None, full=True):
    """`cli.py finetune` with the `human_nontata_promoters` preset (L=251,
    batch 128, lr 1e-3, metric all) on a pretraining run dir, in this
    process with the launches counted and held against the config's count;
    every logged loss finite. With ``full``: the fine-tuning step timed
    (sequences/s, peak memory), one step on the card against the CPU at 2
    layers in fp32, and `finetune_one` for seed 1 run twice on the card,
    bit for bit."""
    import io
    from types import SimpleNamespace

    from caduceus_tpu_torch import cli
    from caduceus_tpu_torch.finetune import (
        _make_classifier, _to_device, finetune_one, make_finetune_step)
    from caduceus_tpu_torch.params import load_run_dir
    from caduceus_tpu_torch.train.checkpoint import load_backbone
    from caduceus_tpu_torch.train.optim import make_optimizer

    torch.cuda.empty_cache()
    _zero_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(_finetune_argv(data_dir, run_dir, epochs, seeds, save_dir))
    cli_s = time.perf_counter() - t0
    counts = _counts()
    lines = [json.loads(x) for x in buf.getvalue().splitlines()
             if x.startswith("{")]
    epochs_logged = [r for r in lines if "epoch" in r]
    results = [r for r in lines if "best_val" in r]
    check(len(epochs_logged) == epochs * len(seeds)
          and len(results) == len(seeds),
          f"finetune {name}: logged {len(epochs_logged)} epochs, "
          f"{len(results)} results")
    check(all(math.isfinite(r["loss"]) for r in epochs_logged),
          f"finetune {name}: a logged loss is not finite: {epochs_logged}")
    cfg, pre = load_run_dir(run_dir, prefer_ema=False)
    dm = _finetune_dm(data_dir, seeds[0])
    steps = epochs * (len(dm.train_ds) // FT_BATCH)
    evals = epochs * -(-len(dm.val_ds) // FT_BATCH) + -(-len(dm.test_ds)
                                                         // FT_BATCH)
    want = {k: v * steps * len(seeds) for k, v in _per_micro_batch(
        cfg).items()}
    fwd = "ssd_fused_fwd" if cfg.ssm_cfg.version == 2 else "bidir_scan_fwd"
    want[fwd] += evals * len(seeds) * (2 if cfg.ssm_cfg.version == 2
                                       else 1) * cfg.n_layer
    check(counts == want, f"finetune {name}: launches {counts} != {want}")
    out = {"n_layer": n_layer, "cli_s": cli_s, "launches": counts,
           "steps_per_seed": steps, "evals_per_seed": evals,
           "results": results, "epochs": epochs_logged,
           "summary": lines[-1]}
    log(f"[finetune] {name}, {n_layer} layers, {FT_TASK} preset (L={FT_L}, "
        f"batch {FT_BATCH}), {len(dm.train_ds)} training sequences, "
        f"{epochs} epochs, seeds {seeds}: cli.py finetune {cli_s:.1f} s; "
        f"launches {counts} (= {steps} steps and {evals} eval batches a "
        f"seed); results {results}; summary {lines[-1]}")
    if not full:
        return out

    # the step, timed: the classifier from run A's weights, as finetune_one
    # builds it
    batches = [_to_device(b, "cuda") for b, _ in zip(
        dm.batches("train", seed=1), range(6))]
    model = _make_classifier(cfg, 2, "mean", False, "left", device="cuda",
                             generator=torch.Generator().manual_seed(1))
    model.load_state_dict(load_backbone(pre, model.state_dict()))
    opt, _ = make_optimizer(model.named_parameters(), lr=1e-3,
                            betas=(0.9, 0.999), warmup_t=2, t_initial=16)
    step = make_finetune_step(model, opt, "single_label_classification")
    step(batches[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [step(b) for b in batches[1:]]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / len(losses)
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(float(x)) for x in losses), "timed step loss")
    out.update(step_s=step_s, sequences_per_s=FT_BATCH / step_s,
               peak_mem_bytes=peak)
    log(f"[finetune] step ({n_layer} layers, {FT_BATCH} x {FT_L}, G={FT_G} "
        f"per kernel call): {step_s * 1e3:.1f} ms, "
        f"{FT_BATCH / step_s:,.0f} sequences/s, peak device memory "
        f"{peak / 2**30:.2f} GiB")
    del model, opt, step, batches

    # card vs CPU, one step at 2 layers, fp32, 32 sequences (gradients
    # before the optimizer: a no-op step)
    cfg2 = dataclasses.replace(cfg, n_layer=2, dtype="float32")
    batch = next(dm.batches("train", seed=3))
    batch = {k: v[:32] for k, v in batch.items()}
    got = {}
    for dev in ("cpu", "cuda"):
        m = _make_classifier(cfg2, 2, "mean", False, "left", device=dev,
                             generator=torch.Generator().manual_seed(7))
        loss = make_finetune_step(m, SimpleNamespace(step=lambda: None),
                                  "single_label_classification")(
            _to_device(batch, dev))
        got[dev] = (float(loss), {n: p.grad.cpu()
                                  for n, p in m.named_parameters()})
    (l_c, g_c), (l_k, g_k) = got["cpu"], got["cuda"]
    rel = abs(l_k - l_c) / abs(l_c)
    check(rel <= TRAIN_TOL["metric"], f"finetune step card vs CPU loss "
          f"{l_k} vs {l_c}")
    g_err, worst = 0.0, ""
    for n in g_c:
        e = ((g_k[n] - g_c[n]).abs().max()
             / (g_c[n].abs().max() + 1e-30)).item()
        if e > g_err:
            g_err, worst = e, n
    check(g_err <= TRAIN_TOL["grad"], f"finetune step card vs CPU gradient "
          f"{worst}: {g_err:.2e} of its max")
    out["vs_cpu"] = {"loss": [l_k, l_c], "loss_rel": rel, "grad_err": g_err,
                     "worst": worst}
    log(f"[finetune] card vs CPU, 2 layers, fp32, 32 x {FT_L}: loss "
        f"{l_k:.7f} vs {l_c:.7f} (rel {rel:.1e}, tol {TRAIN_TOL['metric']}); "
        f"worst gradient {worst} {g_err:.2e} of its max (tol "
        f"{TRAIN_TOL['grad']})")

    # finetune_one for seed 1, twice: bit for bit
    runs = []
    for _ in range(2):
        logs = []
        t0 = time.perf_counter()
        res, best = finetune_one(cfg, _finetune_dm(data_dir, 1), 2,
                                 pretrained_params=pre, epochs=epochs,
                                 seed=1, metric="all", log_fn=logs.append,
                                 return_state=True, device="cuda")
        runs.append((logs, res, best, time.perf_counter() - t0))
    (l1, r1, b1, s1), (l2, r2, b2, s2) = runs
    check(l1 == l2 and r1 == r2, f"finetune_one twice: {l1} != {l2}")
    for k in b1:
        check(torch.equal(b1[k], b2[k]), f"finetune_one twice: {k} differs")
    out["repeat"] = {"logs": l1, "result": r1, "run_s": [s1, s2]}
    log(f"[finetune] finetune_one seed 1 twice ({s1:.1f} s, {s2:.1f} s): "
        f"logs, metrics and best-val parameters equal bit for bit; {r1}")
    torch.cuda.empty_cache()
    return out


def phase_classify(save_dir):
    """`cli.py serve` of the export (`InferenceService.from_run_dir`, the
    same call) over HTTP: /classify of 8 sequences equals a direct forward
    of the exported classifier bit for bit; latency of one sequence and of
    8 concurrent requests."""
    from concurrent.futures import ThreadPoolExecutor

    from caduceus_tpu_torch.finetune import _make_classifier
    from caduceus_tpu_torch.params import from_jax_params, load_npz_params
    from caduceus_tpu_torch.serve import InferenceServer, InferenceService

    svc = InferenceService.from_run_dir(save_dir, device="cuda", max_batch=8)
    n_warm = svc.warmup()
    server = InferenceServer(svc, port=0).start()
    rng = np.random.default_rng(11)
    seqs = ["".join(rng.choice(list("ACGT"), int(n)))
            for n in rng.integers(200, 260, 8)]
    try:
        served = _post(server.port, "/classify", {"sequences": seqs})
        one = []
        for i in range(5):
            t0 = time.perf_counter()
            _post(server.port, "/classify", {"sequences": [seqs[i]]})
            one.append(time.perf_counter() - t0)

        def req(s):
            return _post(server.port, "/classify", {"sequences": [s]})

        def bursts():
            runs = []
            with ThreadPoolExecutor(8) as pool:
                for _ in range(CLASSIFY_BURSTS):
                    t0 = time.perf_counter()
                    list(pool.map(req, seqs))
                    runs.append(time.perf_counter() - t0)
            return runs

        eight = bursts()
        # the same bursts with socketserver's default listen backlog of 5
        # (listen() again sets the backlog of a listening socket)
        server.httpd.socket.listen(5)
        eight_b5 = bursts()
    finally:
        server.stop()
    tc = svc.task_cfg
    cfg = svc.cfg
    model = _make_classifier(cfg, tc["num_classes"], tc["pooling"],
                             tc["use_lengths"], tc["padding_side"],
                             device="cuda")
    model.load_state_dict(from_jax_params(
        load_npz_params(os.path.join(save_dir, "params.npz")), cfg,
        model=model))
    ids = np.stack([svc.tok.encode_padded(s, tc["max_length"],
                                          add_sep=tc["add_eos"])
                    for s in seqs]).astype(np.int64)
    lengths = torch.tensor([min(len(s), tc["max_length"]) for s in seqs])
    with torch.inference_mode():
        scores = model(torch.from_numpy(ids).cuda(), lengths.cuda()).cpu(
        ).numpy()
    for r, s in zip(served["classify"], scores):
        e = np.exp(s - s.max())
        check(r["probs"] == (e / e.sum()).tolist()
              and r["label"] == int(np.argmax(s)),
              f"/classify {r} != direct forward {s}")
    del model, svc
    torch.cuda.empty_cache()

    def spread(runs):
        return {"median_s": float(np.median(runs)),
                "p90_s": float(np.percentile(runs, 90)),
                "max_s": float(max(runs)), "runs": runs}

    out = {"warmup_dispatches": n_warm, "latency_1_s": float(np.median(one)),
           "latency_1_runs": one, "latency_8": spread(eight),
           "latency_8_backlog_5": spread(eight_b5),
           "listen_backlog": server.httpd.request_queue_size}
    log(f"[classify] /classify of the export: 8 sequences equal a direct "
        f"forward bit for bit; one sequence {out['latency_1_s'] * 1e3:.1f} ms "
        f"(median of 5)")
    for key, what in (("latency_8", f"listen backlog "
                       f"{out['listen_backlog']}"),
                      ("latency_8_backlog_5", "listen backlog 5")):
        st = out[key]
        log(f"[classify] 8 concurrent requests, {what}: median "
            f"{st['median_s'] * 1e3:.1f} ms, p90 {st['p90_s'] * 1e3:.1f}, "
            f"max {st['max_s'] * 1e3:.1f} ({CLASSIFY_BURSTS} bursts; "
            f"{sum(r > 0.5 for r in st['runs'])} over 0.5 s)")
    return out


def _vep_variants(path, fasta):
    """`VEP_N` variants at random positions of the genome (a base of ACGT)
    and one more whose reference base is wrong: ``chrom pos ref alt label
    tss_distance`` rows."""
    from caduceus_tpu_torch.data.fasta import FastaFile

    fa = FastaFile(fasta)
    rng = np.random.default_rng(12)
    rows = []
    while len(rows) < VEP_N + 1:
        chrom = fa.names[len(rows) % len(fa.names)]
        pos = int(rng.integers(0, fa.length(chrom)))
        ref = fa.fetch(chrom, pos, pos + 1)
        if ref not in "ACGT":
            continue
        alt = "ACGT"[("ACGT".index(ref) + 1 + len(rows) % 3) % 4]
        if len(rows) == 3:   # the mismatched record: skipped by the dump
            ref, alt = alt, ref
        rows.append((chrom, pos, ref, alt, len(rows) % 2,
                     [1_000, 50_000, 200_000][len(rows) % 3]))
    fa.close()
    with open(path, "w") as f:
        for r in rows:
            f.write("\t".join(map(str, r)) + "\n")
    return rows


def phase_vep(work, fasta, run_dir, name):
    """`cli.py vep --svm` on a run dir at seq_len 131,072, batch 2, over 16
    variants and one with a wrong reference base: 16 feature rows, the
    launches of 8 forwards, the peak-memory line printed once; the first
    variant's features equal a direct `Caduceus` forward of the same batch,
    collapsed to the strand mean and window-meaned; the SVM eval of the
    file on the card, printed last, with finite AUROCs."""
    import io

    from caduceus_tpu_torch import cli, vep
    from caduceus_tpu_torch.data.fasta import FastaFile
    from caduceus_tpu_torch.models.caduceus import (
        Caduceus, collapse_strand_mean)
    from caduceus_tpu_torch.params import load_run_dir
    from caduceus_tpu_torch.tokenization import CaduceusTokenizer

    variants = os.path.join(work, f"variants_{name}.tsv")
    rows = _vep_variants(variants, fasta)
    out_path = os.path.join(work, f"vep_{name}")
    torch.cuda.empty_cache()
    _zero_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(["vep", "--fasta", fasta, "--variants", variants,
                  "--run-dir", run_dir, "--out", out_path, "--seq-len",
                  str(VEP_L), "--batch-size", str(VEP_BATCH), "--svm"])
    secs = time.perf_counter() - t0
    counts = _counts()
    lines = [json.loads(x) for x in buf.getvalue().splitlines()]
    peaks = [x for x in lines if "vep_peak_hbm_gib" in x]
    check(len(peaks) == 1, f"vep {name}: {len(peaks)} peak-memory lines")
    d = np.load(out_path + ".npz")
    feats = d["features"]
    cfg, params = load_run_dir(run_dir)
    check(feats.shape == (VEP_N, 2 * cfg.d_model)
          and np.isfinite(feats).all(), f"vep {name}: {feats.shape}")
    n_fwd = VEP_N // VEP_BATCH
    fwd = "ssd_fused_fwd" if cfg.ssm_cfg.version == 2 else "bidir_scan_fwd"
    per = (2 if cfg.ssm_cfg.version == 2 else 1) * cfg.n_layer
    check(counts[fwd] == n_fwd * per and sum(counts.values()) == n_fwd * per,
          f"vep {name}: launches {counts}")
    # the first batch again, directly: variants 0 and 1 (row 3 is skipped)
    tok = CaduceusTokenizer()
    fa_rows = [r for i, r in enumerate(rows) if i != 3][:VEP_BATCH]
    fa = FastaFile(fasta)
    refs, alts, idx = [], [], []
    for chrom, pos, ref, alt, _, _ in fa_rows:
        seq, vidx = vep.variant_window(fa, chrom, pos, VEP_L)
        refs.append(tok.encode(seq))
        alts.append(tok.encode(seq[:vidx] + alt + seq[vidx + 1:]))
        idx.append(vidx)
    fa.close()
    model = Caduceus(cfg, device="cuda")
    model.load_state_dict({k: v for k, v in params.items()
                           if k.startswith("backbone.")})
    with torch.inference_mode():
        h = collapse_strand_mean(model(torch.from_numpy(
            np.stack(refs + alts).astype(np.int64)).cuda())).float()
        half = vep.WINDOW_SIZE_BP // 2
        win = [h[i, max(0, j - half):min(VEP_L, j + half)].cpu().numpy()
               for i, j in enumerate(idx + idx)]
    direct = np.concatenate([win[0].mean(axis=0), win[VEP_BATCH].mean(
        axis=0)])
    err = float(np.abs(direct - feats[0]).max())
    check(err == 0.0, f"vep {name}: variant 0's features differ from a "
          f"direct forward by {err}")
    del model, h
    torch.cuda.empty_cache()
    svm = lines[-1]
    check(svm.get("n") == VEP_N and math.isfinite(svm["auroc_mean"])
          and len(svm["selected_C"]) > 0, f"vep {name}: SVM eval {svm}")
    out = {"cli_s": secs, "variants_per_s": VEP_N / secs,
           "peak_gib": peaks[0]["vep_peak_hbm_gib"], "launches": counts,
           "direct_max_abs_err": err, "svm": svm}
    log(f"[vep] {name}, {cfg.n_layer} layers, seq_len {VEP_L}, batch "
        f"{VEP_BATCH}: {VEP_N} variants (+1 with a wrong reference base, "
        f"skipped) in {secs:.1f} s of cli.py vep --svm ({VEP_N / secs:.2f} "
        f"variants/s, model load and the SVM eval included), peak "
        f"{peaks[0]} (one line); launches {counts}; variant 0 equals a "
        f"direct forward bit for bit; SVM on the card {svm}")
    return out


SVM_N, SVM_D = 8192, 512     # [svm]: the fit's rows, the dump's width (v2)
SVM_SMALL = 1024             # the card's solve against the CPU's
SVM_KKT_SLACK = 1e-9         # the recomputed kernel's rounding


def _svm_data(n, d, seed=21):
    """Two overlapping classes of VEP-like float32 features: the label
    shifts 16 of the d features by +-0.15."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, n)
    X = rng.normal(size=(n, d)) + 0.15 * (2 * y[:, None] - 1) * (
        np.arange(d) < 16)
    return X.astype(np.float32), y


def _kkt_gap(X, y, alpha, gamma, C):
    """The maximal violating pair's gap of a C-SVC dual point, recomputed
    in float64 on the card apart from the solver: the kernel through
    `torch.cdist` of the differences (the solver expands |a|^2 + |b|^2 -
    2 a.b), G = Q alpha - 1; also the largest box violation and
    |y' alpha|."""
    ys = torch.where(torch.as_tensor(y, device=X.device) == 1, 1.0,
                     -1.0).double()
    K = torch.exp(-gamma * torch.cdist(
        X, X, compute_mode="donot_use_mm_for_euclid_dist").square())
    G = ys * (K @ (alpha * ys)) - 1.0
    v = -ys * G
    pos = ys > 0
    up = torch.where(pos, alpha < C, alpha > 0)
    low = torch.where(pos, alpha > 0, alpha < C)
    gap = (v[up].max() - v[low].min()).item()
    box = max(0.0, -alpha.min().item(), (alpha - C).max().item())
    return gap, box, abs((alpha * ys).sum().item())


def phase_svm():
    """[svm] VEP's SVM on the card (`caduceus_tpu_torch/svm.py`, no
    scikit-learn): a fit at `SVM_N` rows of the dump's feature width (C=1,
    tol 1e-3) timed, then the same fit again (the first pays the process's
    first cuBLAS call and the graph capture where nothing ran before it),
    its KKT gap, box and equality recomputed apart from the solver; at
    `SVM_SMALL` rows the card's decision values against the CPU's solve of
    the same problem, and the card's fit with kernel rows computed on
    demand (`GRAM_BUDGET_BYTES` 0, the path of dumps past 16,384 rows)
    against both (within 2 tol: each stops within tol of the optimum on its
    own rounding)."""
    from caduceus_tpu_torch import svm
    from caduceus_tpu_torch.svm import SVC, StandardScaler

    def timed_fit(X, y):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clf = SVC(C=1.0, device="cuda").fit(X, y)
        torch.cuda.synchronize()
        return clf, time.perf_counter() - t0

    X, y = _svm_data(SVM_N, SVM_D)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Xs = StandardScaler("cuda").fit(X).transform(X)
    torch.cuda.synchronize()
    scale_s = time.perf_counter() - t0
    clf, fit_s = timed_fit(Xs, y)
    again, fit2_s = timed_fit(Xs, y)
    alpha_diff = (again.alpha_ - clf.alpha_).abs().max().item()
    del again
    gap, box, eq = _kkt_gap(Xs, y, clf.alpha_, clf.gamma_, clf.C)
    a = clf.alpha_
    n_free = int(((a > 0) & (a < clf.C)).sum())
    n_bound = int((a >= clf.C).sum())
    log(f"[svm] fit at n={SVM_N}, d={SVM_D} (C=1, tol {clf.tol}) on the "
        f"card: scaler {scale_s:.3f} s; first fit {fit_s:.3f} s, "
        f"{clf.n_iter_} iterations ({fit_s / clf.n_iter_ * 1e6:.1f} us "
        f"each); the same fit again {fit2_s:.3f} s "
        f"({fit2_s / clf.n_iter_ * 1e6:.1f} us each, max |alpha diff| "
        f"{alpha_diff:.1e}); {n_free} free and {n_bound} bounded SVs; "
        f"recomputed KKT gap {gap:.3e}, box violation {box:.1e}, |y'a| "
        f"{eq:.1e}")
    check(gap <= clf.tol + SVM_KKT_SLACK, f"svm: KKT gap {gap} > tol")
    check(box == 0.0 and eq <= 1e-9 * SVM_N, f"svm: box {box}, y'a {eq}")
    small, ys = Xs[:SVM_SMALL].contiguous(), y[:SVM_SMALL]
    card, card_s = timed_fit(small, ys)
    budget = svm.GRAM_BUDGET_BYTES
    svm.GRAM_BUDGET_BYTES = 0
    try:
        rows, rows_s = timed_fit(small, ys)
    finally:
        svm.GRAM_BUDGET_BYTES = budget
    cpu = SVC(C=1.0, device="cpu").fit(small.cpu(), ys)
    pts = Xs[SVM_SMALL:2 * SVM_SMALL]
    f_card, f_rows = card.decision_function(pts), rows.decision_function(pts)
    f_cpu = cpu.decision_function(pts.cpu())
    err = float(np.abs(f_card - f_cpu).max())
    rows_err = float(np.abs(f_rows - f_card).max())
    rows_cpu_err = float(np.abs(f_rows - f_cpu).max())
    log(f"[svm] n={SVM_SMALL}: the card's decision values against the "
        f"CPU's solve: max |diff| {err:.3e} (tol {2 * card.tol}), max|f| "
        f"{np.abs(f_cpu).max():.3f}; iterations {card.n_iter_} / "
        f"{cpu.n_iter_}; card fit {card_s:.3f} s "
        f"({card_s / card.n_iter_ * 1e6:.1f} us an iteration)")
    log(f"[svm] n={SVM_SMALL}, kernel rows on demand (Gram budget 0): "
        f"{rows.n_iter_} iterations, {rows_s:.3f} s "
        f"({rows_s / rows.n_iter_ * 1e6:.1f} us an iteration); decision "
        f"values against the card's Gram fit {rows_err:.3e}, against the "
        f"CPU's {rows_cpu_err:.3e} (tol {2 * card.tol})")
    check(err <= 2 * card.tol, f"svm: card vs CPU decision values {err}")
    check(rows_err <= 2 * card.tol and rows_cpu_err <= 2 * card.tol,
          f"svm: rows on demand vs Gram {rows_err}, vs CPU {rows_cpu_err}")
    out = {"fit_s": fit_s, "fit_again_s": fit2_s, "scaler_s": scale_s,
           "n": SVM_N, "d": SVM_D, "iters": clf.n_iter_, "kkt_gap": gap,
           "free": n_free, "bounded": n_bound, "small_max_abs_err": err,
           "small_iters": [card.n_iter_, cpu.n_iter_], "small_card_s": card_s,
           "rows_iters": rows.n_iter_, "rows_s": rows_s,
           "rows_vs_gram_max_abs_err": rows_err,
           "rows_vs_cpu_max_abs_err": rows_cpu_err}
    del clf, Xs
    torch.cuda.empty_cache()
    return out


# -- context and data parallelism: the CP entry of the fused kernels, the
# parallel pretrain / eval through torch.distributed.run ----------------------

CP_G, CP_L_LOC = 2, 131072          # the CP shape: one sequence, both strands
CP_L = 2 * CP_L_LOC                 # the sequence two ranks share
DP_L = 131072                       # [dp_train]: a global batch of 2 at 131k
CP_LOSS_TOL = 2e-3                  # bf16 full depth: loss, relative
# the v2 depth of [cp_train] / [dp_train]: 8 of hg38_mlm_v2's 16, so that
# the whole script with the tensor-parallel phases stays near 1,000 s of
# its 1,200 (PERF.md §5 has the seconds at 16)
CP_V2_LAYERS = 8
CP_PARAM_SETTLED = {"float32": 1e-3, "bfloat16": 5e-2}  # share of max|g|
CP_PARAM_TOL = {"float32": 1e-6, "bfloat16": 1e-5}      # x (1 + |p|)
CP_NAMES = BWD_NAMES + ("g_edge",)


def _cp_neighbour_rows(xBC, s, n_loc, n, reverse, zero=False):
    """The edge rows of shard s: the 8 raw rows before it (after it when
    ``reverse``), zeros at the sequence edge (or, ``zero``, everywhere: the
    planted fault of an edge read as zeros)."""
    from caduceus_tpu_torch.ops.ssd import HIST_ROWS

    nb = s + 1 if reverse else s - 1
    if zero or not 0 <= nb < n:
        return torch.zeros(xBC.shape[0], HIST_ROWS, xBC.shape[2],
                           dtype=xBC.dtype, device=xBC.device)
    rows = xBC[:, nb * n_loc:(nb + 1) * n_loc]
    return rows[:, :HIST_ROWS] if reverse else rows[:, -HIST_ROWS:]


def cp_split_vs_whole(inp, n, reverse, zero_edges=False):
    """The sequence of ``inp`` cut into n shards run through
    `ssd_batched_fused_cp` in scan order (edge_hist the neighbour's rows,
    h_init the previous shard's hN) against one `ssd_batched_fused` call,
    under autograd: ((y, hN, g_xBC, g_conv_w, g_h0) split, the same
    whole)."""
    from caduceus_tpu_torch.ops.ssd_batched import (ssd_batched_fused,
                                                    ssd_batched_fused_cp)

    G, L, Wc = inp["xBC"].shape
    n_loc = L // n
    out = []
    for split in (True, False):
        xBC = inp["xBC"].detach().clone().requires_grad_(True)
        cw = inp["conv_w"].detach().clone().requires_grad_(True)
        h0 = inp["h_init"].detach().clone().requires_grad_(True)
        args = (inp["A"], cw, inp["conv_b"], inp["D"], inp["dt_bias"])
        if split:
            ys, h = [None] * n, h0
            for s in (range(n - 1, -1, -1) if reverse else range(n)):
                sl = slice(s * n_loc, (s + 1) * n_loc)
                edge = _cp_neighbour_rows(xBC, s, n_loc, n, reverse,
                                          zero_edges)
                ys[s], h = ssd_batched_fused_cp(
                    xBC[:, sl], inp["dt"][:, sl], args[0], *args[1:], h,
                    edge, dims=inp["dims"], dt_softplus=True,
                    reverse=reverse)
            y = torch.cat(ys, 1)
        else:
            y, h = ssd_batched_fused(
                xBC, inp["dt"], args[0], cw, conv_b=args[2], D=args[3],
                dt_bias=args[4], dims=inp["dims"], dt_softplus=True,
                reverse=reverse, h_init=h0, return_final_state=True)
        loss = (y.float() * inp["g_y"].float()).sum() + (h * inp["g_hN"]).sum()
        g = torch.autograd.grad(loss, (xBC, cw, h0))
        out.append((y.detach(), h.detach()) + tuple(t.detach() for t in g))
    return out


def cp_entry_pair(inp, reverse, edge):
    """One shard through the CP entry's kernels (forward with carries, then
    the adjoint with `g_hN`) and through its plain version, with the same
    edge rows: ((y, hN, carries) kernel, same plain), (the 9 gradients
    kernel, same plain)."""
    from caduceus_tpu_torch.ops import ssd as plain
    from caduceus_tpu_torch.ops import ssd_batched as sb

    T = sb.KERNEL_CHUNK[inp["xBC"].dtype]
    a = (inp["xBC"], inp["dt"], inp["A"], inp["conv_w"], inp["conv_b"],
         inp["D"], inp["dt_bias"])
    fk = sb.ssd_fused_fwd(*a, inp["dims"], True, reverse, T, inp["h_init"],
                          save_carries=True, edge_hist=edge)
    fp = plain.ssd_chunked_fused(*a, dims=inp["dims"], dt_softplus=True,
                                 reverse=reverse, chunk_size=T,
                                 h_init=inp["h_init"], return_carries=True,
                                 edge_hist=edge)
    bk = sb.ssd_fused_bwd(*a, inp["g_y"], fk[2], inp["g_hN"], inp["dims"],
                          True, reverse, T, edge_hist=edge)
    bp = plain.ssd_chunked_fused_bwd(*a, inp["g_y"], fp[2], inp["g_hN"],
                                     inp["dims"], True, reverse, T,
                                     edge_hist=edge)
    torch.cuda.synchronize()
    return (fk, fp), (bk, bp)


def phase_cp_kernels():
    """The context-parallel entry of #1 / #3a / #3b (`ssd_batched_fused_cp`,
    edge_hist in, its gradient out) on the card, by the rule of
    `kernel_check.py`: a sequence cut into 2 and 4 shards against the
    unsplit kernel (y, hN and, through the backward, g_xBC, g_conv_w, g_h0),
    one shard against the plain version with its edge rows (all outputs,
    g_edge included), an all-zero edge_hist bit-equal to the entry without
    it (forward and backward), and the planted fault of edge rows read as
    zeros, which must fail; small shape (G=2, L=2048, fp32 and bf16, both
    directions), then the CP shape (G=2, two shards of 131,072 rows, bf16),
    and #1 / #3a / #3b timed there with and without edge_hist."""
    from caduceus_tpu_torch.kernel_check import TOL
    from caduceus_tpu_torch.ops import ssd as plain
    from caduceus_tpu_torch.ops import ssd_batched as sb

    H, P, NG, N, K = 8, 64, 1, 128, 4
    out = {"split": {}, "entry": {}, "zero_edge_bits": {}, "fault": {}}
    shapes = [(2048, dt, n) for dt in (torch.float32, torch.bfloat16)
              for n in (2, 4)] + [(CP_L, torch.bfloat16, 2)]
    for L, dtype, n in shapes:
        for reverse in (False, True):
            inp = ssd_inputs(CP_G, L, H, P, NG, N, K, dtype, 41 + n)
            d = "rev" if reverse else "fwd"
            tag = f"G={CP_G} L={L} {str(dtype)[6:]} {d} {n} shards"
            got, want = cp_split_vs_whole(inp, n, reverse)
            out["split"][tag] = hold(
                f"split vs whole, {tag}", TOL[dtype], got, want,
                names=("y", "hN", "g_xBC", "g_conv_w", "g_h0"), tag="cp")
            if n == 2:
                fault, _ = cp_split_vs_whole(inp, n, reverse, zero_edges=True)
                out["fault"][tag] = hold(
                    f"planted fault (edge_hist read as zeros), {tag}",
                    TOL[dtype], fault[:1], want[:1], names=("y",),
                    expect_ok=False, tag="cp")
            L_loc = L // n
            sh = ssd_inputs(CP_G, L_loc, H, P, NG, N, K, dtype, 7 + n)
            edge = torch.randn(CP_G, 8, sh["xBC"].shape[2], device="cuda",
                               generator=torch.Generator(device="cuda")
                               .manual_seed(3)).to(dtype)
            (fk, fp), (bk, bp) = cp_entry_pair(sh, reverse, edge)
            et = f"G={CP_G} L={L_loc} {str(dtype)[6:]} {d}"
            out["entry"][et] = {
                "fwd": hold(f"CP entry vs plain, {et}", TOL[dtype], fk, fp,
                            tag="cp"),
                "bwd": hold(f"CP entry adjoint vs plain, {et}", TOL[dtype],
                            bk, bp, names=CP_NAMES, tag="cp")}
            if n == 2 and L == 2048 or L == CP_L:
                zero = torch.zeros_like(edge)
                (z, _), (zb, _) = cp_entry_pair(sh, reverse, zero)
                (u, _), (ub, _) = cp_entry_pair(sh, reverse, None)
                same = [torch.equal(a, b) for a, b in
                        zip(tuple(z) + tuple(zb[:8]), tuple(u) + tuple(ub))]
                check(all(same), f"{et}: an all-zero edge_hist changed the "
                      f"bits of {[nm for nm, s in zip(FWD_NAMES + BWD_NAMES, same) if not s]}")
                out["zero_edge_bits"][et] = True
                log(f"[cp] {et}: all-zero edge_hist equals the entry without "
                    "it bit for bit (y, hN, carries and the 8 gradients)")
            del inp, sh
            gc.collect()
            torch.cuda.empty_cache()
    # the adjoint with h_init and a final-state cotangent at the CP shape,
    # as pass 1 of the two-pass scan gives it (g_y = 0): ROADMAP.md queue 3
    # item 7's case on the model path
    out["ghn"] = {}
    for reverse in (False, True):
        inp = ssd_inputs(CP_G, CP_L_LOC, H, P, NG, N, K, torch.bfloat16,
                         760 + reverse)
        inp["g_y"] = torch.zeros_like(inp["g_y"])
        out["ghn"][f"rev={reverse}"] = _hold_ghn(
            inp, reverse, 760 + reverse,
            f"G={CP_G} L={CP_L_LOC} bf16 rev={reverse}, g_y = 0",
            misses=CP_GHN_KNOWN_MISSES, on_cpu=False)
        del inp
        gc.collect()
        torch.cuda.empty_cache()
    out["timing"] = _cp_timing()
    return out


def _cp_timing(H=8):
    """#1 (carries saved), #3a and #3b at the CP shape (G=2, L=131072,
    bf16, forward direction; H heads: the model's 8, or one rank's 4 under
    tensor parallelism) with and without edge_hist, each beside its bound
    (the edge rows and g_edge added to the traffic) and its plain version
    with the edge rows."""
    from caduceus_tpu_torch.ops import ssd as plain
    from caduceus_tpu_torch.ops import ssd_batched as sb

    P, NG, N, K = 64, 1, 128, 4
    inp = ssd_inputs(CP_G, CP_L_LOC, H, P, NG, N, K, torch.bfloat16, 11)
    T = sb.KERNEL_CHUNK[torch.bfloat16]
    Wc = inp["xBC"].shape[2]
    edge = inp["xBC"][:, :8].contiguous()
    a = (inp["xBC"], inp["dt"], inp["A"], inp["conv_w"], inp["conv_b"],
         inp["D"], inp["dt_bias"])
    bounds = _ssd_bounds(CP_G, CP_L_LOC, H, P, NG, N, K, T)
    eb = CP_G * 8 * Wc
    b_cp = {"ssd_fused_fwd": _bound(bounds["ssd_fused_fwd"]["bytes"] + eb * 2,
                                    bounds["ssd_fused_fwd"]["flops"]),
            "ssd_fused_bwd_kernel": _bound(
                bounds["ssd_fused_bwd_kernel"]["bytes"] + eb * 2,
                bounds["ssd_fused_bwd_kernel"]["flops"]),
            "ssd_conv_bwd_kernel": _bound(
                bounds["ssd_conv_bwd_kernel"]["bytes"] + eb * 6,
                bounds["ssd_conv_bwd_kernel"]["flops"], FP32_FLOP_PER_S)}
    _, _, car, _ = sb.fused_fwd_call(*a, inp["dims"], True, False, T,
                                     inp["h_init"], True, edge_hist=edge)
    (g_xc, *_), _ = sb.adjoint_xc_call(*a, inp["g_y"], car, inp["g_hN"],
                                       inp["dims"], True, False, T,
                                       edge_hist=edge)
    out = {}
    calls = {
        "ssd_fused_fwd": (
            lambda e: sb.fused_fwd_call(*a, inp["dims"], True, False, T,
                                        inp["h_init"], True, edge_hist=e),
            lambda: plain.ssd_chunked_fused(
                *a, dims=inp["dims"], dt_softplus=True, chunk_size=T,
                h_init=inp["h_init"], return_carries=True, edge_hist=edge)),
        "ssd_fused_bwd_kernel": (
            lambda e: sb.adjoint_xc_call(*a, inp["g_y"], car, inp["g_hN"],
                                         inp["dims"], True, False, T,
                                         edge_hist=e),
            lambda: plain.ssd_adjoint_xc(*a, inp["g_y"], car, inp["g_hN"],
                                         inp["dims"], True, False, T,
                                         edge_hist=edge)),
        "ssd_conv_bwd_kernel": (
            lambda e: sb.conv_silu_bwd(g_xc, inp["xBC"], inp["conv_w"],
                                       inp["conv_b"], False, edge_hist=e),
            lambda: plain.conv_silu_bwd(g_xc, inp["xBC"], inp["conv_w"],
                                        inp["conv_b"], False,
                                        edge_hist=edge))}
    for name, (kernel, plain_fn) in calls.items():
        kernel(edge)     # warm up: a first call once took 110 ms of 14
        torch.cuda.synchronize()
        t = _timed(lambda: kernel(edge), plain_fn)
        # without edge_hist, between two more runs with it
        t["without_edge_ms_runs"] = [_time_cuda(lambda: kernel(None), 3)
                                     for _ in range(2)]
        t["kernel_ms_runs"].append(_time_cuda(lambda: kernel(edge), 3))
        t["ms"] = float(np.mean(t["kernel_ms_runs"]))
        t["without_edge_ms"] = float(np.mean(t["without_edge_ms_runs"]))
        t.update(b_cp[name])
        out[name] = t
        log(f"[cp] time {name} at G={CP_G} L={CP_L_LOC} H={H} bf16: "
            f"{t['ms']:.3f} ms with edge_hist, {t['without_edge_ms']:.3f} ms "
            f"without; bound {t['bound_ms']:.3f} ms ({t['bound_by']}); "
            f"plain {t['plain_ms']:.1f} ms")
    # the max error of each CP kernel's output at this shape
    (fk, fp), (bk, bp) = cp_entry_pair(inp, False, edge)
    from caduceus_tpu_torch.kernel_check import TOL, compare

    tol = TOL[torch.bfloat16]
    xc_k, _ = sb.adjoint_xc_call(*a, inp["g_y"], fk[2], inp["g_hN"],
                                 inp["dims"], True, False, T, edge_hist=edge)
    xc_p = plain.ssd_adjoint_xc(*a, inp["g_y"], fp[2], inp["g_hN"],
                                inp["dims"], True, False, T, edge_hist=edge)
    out["ssd_fused_fwd"]["check"] = compare(fk[0], fp[0], tol)
    out["ssd_fused_bwd_kernel"]["check"] = compare(xc_k[0], xc_p[0], tol)
    out["ssd_conv_bwd_kernel"]["check"] = compare(bk[8], bp[8], tol)
    out["ssd_conv_bwd_kernel"]["check_g_xBC"] = compare(bk[0], bp[0], tol)
    for name in out:
        check(out[name]["check"]["ok"], f"{name} at the CP shape: "
              f"{out[name]['check']}")
    del inp
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- the ranks: chip_smoke.py --rank-job FILE under torch.distributed.run ----

def _task_model(task, device, parallel=True):
    """The task's seeded model on ``device``: a Caduceus config (with the
    task's parallel axes when ``parallel``) or a Hyena model's keyword
    arguments (``family`` "hyena")."""
    from caduceus_tpu_torch.config import CaduceusConfig
    from caduceus_tpu_torch.models.caduceus import CaduceusForMaskedLM
    from caduceus_tpu_torch.models.hyena import HyenaLMHeadModel

    gen = torch.Generator().manual_seed(task["seed"])
    if task.get("family") == "hyena":
        with open(task["config"]) as f:
            kw = json.load(f)
        return HyenaLMHeadModel(device=device, generator=gen, **kw)
    cfg = CaduceusConfig.load(task["config"])
    if parallel and task["cp"]:
        cfg.context_parallel_axis = ("seq" if task.get("seq", 1) > 1
                                     else "model")
    if parallel and task.get("tp"):
        cfg.tensor_parallel_axis = "model"
    return CaduceusForMaskedLM(cfg, device=device, generator=gen)


def _all_counts():
    return {**_counts(), **_attn_counts()}


def _zero_all():
    _zero_counts()
    _attn_zero()


def _rank_step(task):
    """One train step of a seeded model on this rank's part of the first
    global batch (`Trainer`'s step with the mesh; under tensor parallelism
    the model cut by `shard_module_`, its gradient and parameters gathered
    whole): the loss, this rank's logits (a forward without grad first),
    the clipped gradient and the updated parameters, written for the
    parent to hold against one rank. Under tensor parallelism the step
    also checks that every model rank's shared gradients are equal
    (`trainer.check_shared`, at step 0; it raises otherwise)."""
    from caduceus_tpu_torch.parallel.mesh import (make_mesh, set_global_mesh,
                                                  shard_batch)
    from caduceus_tpu_torch.parallel.sharding import shard_module_
    from caduceus_tpu_torch.train.optim import make_optimizer
    from caduceus_tpu_torch.train.trainer import (TrainState, make_train_step,
                                                  to_device)

    mesh = make_mesh(model=task["mesh_model"], backend="gloo")
    model = _task_model(task, mesh.device)
    plan = None
    if task["cp"] or task.get("tp"):
        set_global_mesh(mesh)
    if task.get("tp"):
        plan = shard_module_(model, mesh)
    batch = _first_batch(task)
    dev_b = to_device(shard_batch(mesh, batch, cp=task["cp"]), mesh.device)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        logits = model(dev_b["input_ids"]).cpu()
    opt, _ = make_optimizer(model.named_parameters(), **_CP_OPT)
    step = make_train_step(mesh=mesh, tp_plan=plan)
    _zero_all()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, m = step(TrainState(model, opt), dev_b)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    res = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "step_s": secs, "launches": _all_counts(),
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "shared_grads_equal": plan is not None}
    grads = {n: p.grad.detach() for n, p in model.named_parameters()}
    params = {n: p.detach() for n, p in model.named_parameters()}
    if plan is not None:
        grads, params = plan.gather_state(grads), plan.gather_state(params)
    r = mesh.rank
    blob = {"logits": logits}
    if r == 0:
        blob["grads"] = {n: g.cpu() for n, g in grads.items()}
        blob["params"] = {n: p.cpu() for n, p in params.items()}
    torch.save(blob, os.path.join(task["out"], f"{task['name']}_{r}.pt"))
    set_global_mesh(None)
    del model, opt, dev_b, logits, blob, grads, params
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _rank_grad(task):
    """[cp_tp] on this rank of a (1, model, seq) grid: the seeded v2 model
    with tensor_parallel_axis "model" and context_parallel_axis "seq", cut
    by `shard_module_`, on the whole ids of one sequence (each rank computes
    the logits of its seq shard, its heads); the gradient of the sum of the
    squares of the logits (the JAX test's loss), gathered over the model
    axis and summed over the seq axis; this rank's logits, seconds, peak
    memory and launches."""
    from caduceus_tpu_torch.parallel import comm
    from caduceus_tpu_torch.parallel.mesh import make_mesh, set_global_mesh
    from caduceus_tpu_torch.parallel.sharding import shard_module_

    mesh = make_mesh(model=task["mesh_model"], seq=task["seq"],
                     backend="gloo")
    model = _task_model(task, mesh.device)
    set_global_mesh(mesh)
    plan = shard_module_(model, mesh)
    ids = _grad_ids(task).to(mesh.device)
    torch.cuda.reset_peak_memory_stats()
    _zero_all()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = model(ids)
    logits.float().square().sum().backward()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    res = {"s": secs, "launches": _all_counts(),
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "coord": [mesh.coord("model"), mesh.coord("seq")]}
    grads = plan.gather_state({n: p.grad.detach()
                               for n, p in model.named_parameters()})
    for g in grads.values():
        comm.all_reduce_(g, mesh.axis("seq"))
    blob = {"logits": logits.detach().cpu()}
    if mesh.rank == 0:
        blob["grads"] = {n: g.cpu() for n, g in grads.items()}
    torch.save(blob, os.path.join(task["out"],
                                  f"{task['name']}_{mesh.rank}.pt"))
    set_global_mesh(None)
    del model, logits, blob, grads
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _rank_eval(task):
    """[cp_eval]'s eval step on this rank (model axis 2, context parallel):
    the seeded model on its columns of the first global batch (with loss
    weights), `make_eval_step` with per_token and each last_k of the task;
    every metric (the per-position vectors whole) to
    ``<out>/<name>_<rank>.pt``; seconds, peak memory, launches."""
    from caduceus_tpu_torch.parallel.mesh import (make_mesh, set_global_mesh,
                                                  shard_batch)
    from caduceus_tpu_torch.train.trainer import make_eval_step, to_device

    mesh = make_mesh(model=task["mesh_model"], backend="gloo")
    model = _task_model(task, mesh.device)
    set_global_mesh(mesh)
    b = to_device(shard_batch(mesh, _first_batch(task), cp=True), mesh.device)
    torch.cuda.reset_peak_memory_stats()
    _zero_all()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = []
    for k in task["last_ks"]:
        m = make_eval_step(model, last_k=k, per_token=True, mesh=mesh)(None,
                                                                       b)
        out.append({n: v.cpu() for n, v in m.items()})
    torch.cuda.synchronize()
    res = {"s": time.perf_counter() - t0, "launches": _all_counts(),
           "peak_bytes": torch.cuda.max_memory_allocated()}
    torch.save(out, os.path.join(task["out"],
                                 f"{task['name']}_{mesh.rank}.pt"))
    set_global_mesh(None)
    del model, b, out
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _embeds_inputs(task):
    """The seeded (1, L, d_model) embeddings and the cotangent R of the
    loss sum(h R)."""
    from caduceus_tpu_torch.config import CaduceusConfig

    d = CaduceusConfig.load(task["config"]).d_model
    rng = np.random.default_rng(task["seed"] + 2)
    emb, cot = rng.standard_normal((2, 1, task["L"], d), np.float32)
    return torch.from_numpy(emb), torch.from_numpy(cot)


def _embeds_model(task, device, cp):
    from caduceus_tpu_torch.config import CaduceusConfig
    from caduceus_tpu_torch.models.caduceus import Caduceus

    cfg = CaduceusConfig.load(task["config"])
    if cp:
        cfg.context_parallel_axis = "model"
    return Caduceus(cfg, device=device,
                    generator=torch.Generator().manual_seed(task["seed"]))


def _rank_embeds(task):
    """The CP phase's ``inputs_embeds`` check on this rank: the seeded
    non-RCPS v2 backbone with context_parallel_axis "model", given the
    whole embeddings, keeps its columns; its hidden states, the gradient of
    sum(h R) for the embeddings (zero outside its columns, checked here)
    and, all-reduced over the ranks as the trainer does, for the
    parameters."""
    from caduceus_tpu_torch.parallel import comm
    from caduceus_tpu_torch.parallel.mesh import make_mesh, set_global_mesh

    mesh = make_mesh(model=task["mesh_model"], backend="gloo")
    model = _embeds_model(task, mesh.device, cp=True)
    set_global_mesh(mesh)
    emb, cot = _embeds_inputs(task)
    n = task["L"] // mesh.shape["model"]
    cols = slice(mesh.coord("model") * n, (mesh.coord("model") + 1) * n)
    e = emb.to(mesh.device).requires_grad_(True)
    torch.cuda.reset_peak_memory_stats()
    _zero_all()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h, _ = model.backbone(None, inputs_embeds=e)
    (h.float() * cot[:, cols].to(mesh.device)).sum().backward()
    torch.cuda.synchronize()
    res = {"s": time.perf_counter() - t0, "launches": _all_counts(),
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "zero_outside": not (bool(e.grad[:, :cols.start].any())
                                or bool(e.grad[:, cols.stop:].any()))}
    grads = {k: (torch.zeros_like(p) if p.grad is None else p.grad)
             for k, p in model.named_parameters()}
    for g in grads.values():
        comm.all_reduce_(g, mesh.world_axis())
    blob = {"h": h.detach().cpu(), "g_emb": e.grad[:, cols].cpu()}
    if mesh.rank == 0:
        blob["grads"] = {k: g.cpu() for k, g in grads.items()}
    torch.save(blob, os.path.join(task["out"],
                                  f"{task['name']}_{mesh.rank}.pt"))
    set_global_mesh(None)
    del model, e, h, blob, grads
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _grad_ids(task):
    """The seeded ids of a [cp_tp] task: one sequence of L tokens."""
    rng = np.random.default_rng(task["seed"])
    return torch.from_numpy(rng.integers(7, 11, (1, task["L"])).astype(
        np.int64))


# warmup_t=0: step 0 runs at the full lr, so the update is not tiny
_CP_OPT = dict(lr=8e-3, warmup_t=0, t_initial=50_000, weight_decay=0.1)


def _first_batch(task):
    """The first global batch of the task's loader (the same on every rank:
    the same seed), as numpy: MLM, or next-token for the Hyena LM; with
    ``weighted`` also seeded loss weights in [0.1, 2)."""
    from caduceus_tpu_torch.data.hg38 import HG38DataModule

    dm = HG38DataModule(task["bed"], task["fasta"], max_length=task["L"],
                        batch_size=task["batch"],
                        mlm=task.get("family") != "hyena", seed=task["seed"])
    loader = dm.train_loader()
    try:
        batch = next(iter(loader))
    finally:
        if hasattr(loader, "close"):
            loader.close()
    if task.get("weighted"):
        # GPN-style per-position loss weights, seeded
        batch["loss_weights"] = np.random.default_rng(task["seed"] + 1).uniform(
            0.1, 2.0, batch["targets"].shape).astype(np.float32)
    return batch


def rank_job(path) -> int:
    """Run the tasks of a job file on this rank (``RANK`` from the
    launcher): ``step`` (`_rank_step`), ``grad`` (`_rank_grad`), ``eval``
    (`_rank_eval`), ``embeds`` (`_rank_embeds`), ``cut_run`` or ``cli``
    (`cli.main` with its argv: the user's entry point), each with its
    launch counts, seconds, peak device memory and stdout; results to
    ``<out>/rank<r>.json``."""
    import io

    import torch.distributed as dist

    from caduceus_tpu_torch import cli

    with open(path) as f:
        job = json.load(f)
    r = int(os.environ["RANK"])
    torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0"))
                          % torch.cuda.device_count())
    # one process group for every task (a process the launcher started
    # cannot initialize one again): the meshes of the tasks reuse it
    dist.init_process_group("gloo")
    res = []
    for task in job["tasks"]:
        if task["kind"] in ("step", "grad", "eval", "embeds"):
            res.append({"step": _rank_step, "grad": _rank_grad,
                        "eval": _rank_eval,
                        "embeds": _rank_embeds}[task["kind"]](task))
            continue
        if task["kind"] == "cut_run":
            if r == 0:
                _cut_run(task["src"], task["dst"])
            dist.barrier()
            res.append({})
            continue
        torch.cuda.reset_peak_memory_stats()
        _zero_all()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.main(task["argv"])
        torch.cuda.synchronize()
        res.append({"s": time.perf_counter() - t0, "launches": _counts(),
                    "attn_launches": _attn_counts(),
                    "peak_bytes": torch.cuda.max_memory_allocated(),
                    "stdout": buf.getvalue()})
        gc.collect()
        torch.cuda.empty_cache()
    with open(os.path.join(job["out"], f"rank{r}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()
    return 0


def _launch_ranks(tasks, out_dir, name, n=2):
    """`python -m torch.distributed.run --standalone --nproc_per_node n
    chip_smoke.py --rank-job JOB` from the checkout: every task on every
    rank; the launcher's exit code is the worst rank's. Returns each rank's
    results (the kernels were built by this process, into build/)."""
    root = os.path.dirname(os.path.abspath(__file__))
    job = os.path.join(out_dir, f"{name}.json")
    with open(job, "w") as f:
        json.dump({"tasks": tasks, "out": out_dir}, f)
    log_path = os.path.join(out_dir, f"{name}.log")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with open(log_path, "wb") as out:
        rc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", str(n), os.path.abspath(__file__),
             "--rank-job", job], cwd=root, stdout=out,
            stderr=subprocess.STDOUT, timeout=900).returncode
    secs = time.perf_counter() - t0
    check(rc == 0, f"{name}: the launcher exited {rc}:\n"
          f"{_tail(log_path, 200)}")
    ranks = []
    for r in range(n):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
        os.remove(os.path.join(out_dir, f"rank{r}.json"))
    log(f"[{name}] {n} ranks (gloo, one card) ran {len(tasks)} tasks in "
        f"{secs:.1f} s (launcher included)")
    return ranks, secs


def _reference_step(task):
    """The same step on one rank, no mesh: (loss, logits, grads, params,
    step seconds)."""
    from caduceus_tpu_torch.train.optim import make_optimizer
    from caduceus_tpu_torch.train.trainer import (TrainState, make_train_step,
                                                  to_device)

    model = _task_model(task, "cuda", parallel=False)
    b = to_device(_first_batch(task), torch.device("cuda"))
    with torch.no_grad():
        logits = model(b["input_ids"]).cpu()
    p0 = {n: p.detach().double().cpu() for n, p in model.named_parameters()}
    opt, _ = make_optimizer(model.named_parameters(), **_CP_OPT)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, m = make_train_step()(TrainState(model, opt), b)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    out = (float(m["loss"]), logits,
           {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
           {n: p.detach().cpu() for n, p in model.named_parameters()},
           p0, secs)
    del model, opt, b
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _hold_rank_step(task, ranks, idx, out_dir):
    """Hold the ranks' step against one rank's on the same weights and
    batch: in fp32 the loss within 1e-4 relative, the logits by the fp32
    kernel rule and each gradient within `TRAIN_TOL` grad of its max with
    rel_l2 <= 1e-4; in bf16 the loss within `CP_LOSS_TOL` relative and the
    logits within `BF16_MODEL_TOL` of max|logit|; the updated parameters
    where one rank's |g| is settled (above `CP_PARAM_SETTLED` of its
    largest, and for TP in bf16 above `TRAIN_TOL` adam_floor) within
    `CP_PARAM_TOL` (1 + |p|), elsewhere 2 lr; and every
    updated parameter within `TRAIN_TOL` param (1 + |p|) of AdamW's first
    step computed in fp64 from the ranks' own (gathered, clipped)
    gradient."""
    from caduceus_tpu_torch.kernel_check import TOL, compare

    from caduceus_tpu_torch.config import CaduceusConfig
    from caduceus_tpu_torch.train.optim import weight_decay_mask

    name, dtype = task["name"], task["dtype"]
    if task.get("family") == "hyena":
        want = _hyena_per_step(task)
    else:
        cfg = CaduceusConfig.load(task["config"])
        want = (_cp_per_step(cfg, cfg.n_layer) if task["cp"]
                else _tp_per_step(cfg) if task.get("tp")
                else _per_micro_batch(cfg))
    want = {**dict.fromkeys(_all_counts(), 0), **want}
    for r, rk in enumerate(ranks):
        check(rk[idx]["launches"] == want, f"{name} rank {r}: launches "
              f"{rk[idx]['launches']} != {want}")
    loss, logits, grads, params, p0, ref_s = _reference_step(task)
    blobs = [torch.load(os.path.join(out_dir, f"{name}_{r}.pt"))
             for r in range(len(ranks))]
    got_loss = ranks[0][idx]["loss"]
    check(all(rk[idx]["loss"] == got_loss for rk in ranks),
          f"{name}: the ranks' losses differ")
    if task.get("tp"):
        # the model ranks hold the same logits, bit for bit
        check(all(torch.equal(b["logits"], blobs[0]["logits"])
                  for b in blobs), f"{name}: the model ranks' logits differ")
        got_logits = blobs[0]["logits"]
    else:
        # CP: the ranks' logits are sequence shards; DP: batch rows
        got_logits = torch.cat([b["logits"] for b in blobs],
                               1 if task["cp"] else 0)
    rel = abs(got_loss - loss) / abs(loss)
    res = {"loss": [got_loss, loss], "loss_rel": rel,
           "step_s_2ranks": [rk[idx]["step_s"] for rk in ranks],
           "step_s_1rank": ref_s,
           "peak_bytes": [rk[idx]["peak_bytes"] for rk in ranks],
           "launches": [rk[idx]["launches"] for rk in ranks]}
    if dtype == "float32":
        check(rel <= 1e-4, f"{name}: loss {got_loss} vs one rank {loss}")
        st = compare(got_logits, logits, TOL[torch.float32])
        check(st["ok"], f"{name}: logits {st}")
        res["logits"] = st
        worst = 0.0
        for n, g in grads.items():
            gs = compare(blobs[0]["grads"][n], g, TOL[torch.float32])
            e = gs["max_abs_err"] / (gs["max_abs_ref"] + 1e-30)
            check(gs["rel_l2"] <= 1e-4 and e <= TRAIN_TOL["grad"],
                  f"{name}: gradient {n}: {gs}")
            worst = max(worst, e)
        res["grad_err"] = worst
    else:
        check(rel <= CP_LOSS_TOL, f"{name}: loss {got_loss} vs one rank "
              f"{loss} (rel {rel:.2e} > {CP_LOSS_TOL})")
        e = ((got_logits - logits).abs().max() / logits.abs().max()).item()
        check(e <= BF16_MODEL_TOL, f"{name}: logits {e:.2e} of max|logit|")
        res["logits_err"] = e
        # the gradients (read, not held): the worst rel_l2 and the worst
        # max error in units of its tensor's max|g|
        worst = {"rel_l2": (0.0, ""), "max": (0.0, "")}
        for n, g in grads.items():
            gs = compare(blobs[0]["grads"][n], g, TOL[torch.bfloat16])
            e = gs["max_abs_err"] / (gs["max_abs_ref"] + 1e-30)
            for k, v in (("rel_l2", gs["rel_l2"]), ("max", e)):
                if v > worst[k][0]:
                    worst[k] = (v, n)
        res["grad_err"] = worst
    lr, wd = _CP_OPT["lr"], _CP_OPT["weight_decay"]   # step 0's lr
    # TP in bf16: a rank's matmuls run at other shapes than one rank's, so
    # bf16 roundings flip all through the step, and v2's dt_bias gradients,
    # sums over 262,144 rows that cancel to ~1e-7, differ by 10-30% from
    # one rank's (PERF.md §6). Within `TRAIN_TOL` adam_floor (100 eps) of 0
    # Adam's first step lr·g/(|g| + eps) turns on those digits, so there
    # the bound is 2·lr (the AdamW recomputation below holds every element)
    floor = (TRAIN_TOL["adam_floor"] if task.get("tp") and dtype == "bfloat16"
             else 0.0)
    decay = weight_decay_mask(params.items())
    p_err = adam_err = 0.0
    bad = []
    for n, p in params.items():
        g, got = grads[n], blobs[0]["params"][n]
        s = g.abs().max().item() + 1e-30
        scale = 1 + p0[n].abs().float()
        # every element: AdamW's first step from the ranks' own gradient,
        # in fp64: p·(1 - lr·wd) - lr·g / (|g| + eps) (m̂ = g, √v̂ = |g|)
        gr = blobs[0]["grads"][n].double()
        ref = p0[n] * (1 - lr * wd * decay[n]) - lr * gr / (gr.abs() + 1e-8)
        a = ((got.double() - ref).abs() / scale.double()).max().item()
        check(a <= TRAIN_TOL["param"], f"{name}: the ranks' update of {n} "
              f"vs AdamW from their own gradient: {a:.2e}·(1+|p|)")
        adam_err = max(adam_err, a)
        # against one rank: strict where one rank's gradient is well above
        # 0; near 0 the sign of g decides Adam's first step, so there 2·lr
        settled = (g.abs() > CP_PARAM_SETTLED[dtype] * s) & (g.abs() > floor)
        d = (got - p).abs()
        lim = torch.where(settled, CP_PARAM_TOL[dtype] * scale,
                          torch.full_like(d, 2 * lr))
        over = (d > lim).reshape(-1)
        if bool(over.any()):
            gk = blobs[0]["grads"][n].reshape(-1)
            for i in over.nonzero()[:, 0][:8].tolist():
                bad.append(f"{n}[{i}] |diff| {d.reshape(-1)[i].item():.3e} "
                           f"limit {lim.reshape(-1)[i].item():.3e} g(one "
                           f"rank) {g.reshape(-1)[i].item():.4e} g(ranks) "
                           f"{gk[i].item():.4e} max|g| {s:.3e} p "
                           f"{p0[n].reshape(-1)[i].item():.4e}")
            bad.append(f"{n}: {int(over.sum())} of {over.numel()} over")
        p_err = max(p_err, ((d / scale) * settled).max().item())
    check(not bad, f"{name}: updated parameters vs one rank (gradients: "
          f"{res['grad_err']}):\n  " + "\n  ".join(bad))
    res["param_err"], res["adam_err"] = p_err, adam_err
    for r in range(len(ranks)):
        os.remove(os.path.join(out_dir, f"{name}_{r}.pt"))
    if task.get("tp"):
        res["shared_grads_equal"] = all(rk[idx]["shared_grads_equal"]
                                        for rk in ranks)
    log(f"[{name}] step on {len(ranks)} ranks vs one rank, same weights and "
        f"batch ({dtype}): loss {got_loss:.6f} vs {loss:.6f} (rel "
        f"{rel:.2e}); logits {res.get('logits_err', res.get('logits', {}).get('rel_l2'))}; "
        f"gradients {res['grad_err']}; "
        f"updated parameters {p_err:.2e}·(1+|p|) where settled, "
        f"{adam_err:.2e}·(1+|p|) from AdamW of the ranks' own gradient; step "
        f"{', '.join(f'{s:.2f}' for s in res['step_s_2ranks'])} s per rank "
        f"(two ranks time-sharing one card) vs {ref_s:.2f} s on one rank; "
        f"peak {', '.join(f'{b / 2**30:.2f}' for b in res['peak_bytes'])} GiB "
        f"per rank; launches {res['launches'][0]}")
    return res


# [cp_eval]'s last_k: spanning both ranks, the last rank's columns only,
# and past L (the whole row)
CP_EVAL_LAST_KS = (CP_L - CP_L // 4, CP_L // 4, CP_L + 1)
# the per-token NLL's bound from the logits' rule: |d NLL| <= 2 max|d logit|
CP_EVAL_LOGIT_TOL = {"float32": 1e-4, "bfloat16": BF16_MODEL_TOL}


def _hold_rank_eval(task, ranks, idx, out_dir):
    """Hold [cp_eval]'s eval step on the ranks against the same step on one
    rank (whole batch, no mesh) on the card, for each last_k: every rank
    the same metrics bit for bit; the weighted loss, loss_sum, acc and the
    last-k sum within 1e-4 relative in fp32 and `CP_LOSS_TOL` in bf16 (the
    rank step's loss rule); the counts and the per-position counts equal;
    the per-position NLL sums within 2 x `CP_EVAL_LOGIT_TOL` x max|logit|
    (one token's NLL moves at most twice its largest logit's error)."""
    from caduceus_tpu_torch.config import CaduceusConfig
    from caduceus_tpu_torch.train.trainer import make_eval_step, to_device

    name, dtype = task["name"], task["dtype"]
    # per forward: two directions x two passes of the CP scan a layer
    want_l = {**dict.fromkeys(_all_counts(), 0), "ssd_fused_cp": len(
        task["last_ks"]) * 4 * CaduceusConfig.load(task["config"]).n_layer}
    for r, rk in enumerate(ranks):
        check(rk[idx]["launches"] == want_l, f"{name} rank {r}: launches "
              f"{rk[idx]['launches']} != {want_l}")
    model = _task_model(task, "cuda", parallel=False)
    b = to_device(_first_batch(task), torch.device("cuda"))
    t0 = time.perf_counter()
    want = []
    with torch.inference_mode():
        for k in task["last_ks"]:
            m = make_eval_step(model, last_k=k, per_token=True)(None, b)
            want.append({n: v.cpu() for n, v in m.items()})
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
        scale = model(b["input_ids"]).abs().max().item()
    del model, b
    gc.collect()
    torch.cuda.empty_cache()
    got = [torch.load(os.path.join(out_dir, f"{name}_{r}.pt"))
           for r in range(len(ranks))]
    for r in range(1, len(ranks)):
        check(all(torch.equal(got[r][i][n], got[0][i][n])
                  for i in range(len(want)) for n in got[0][i]),
              f"{name}: rank {r}'s metrics differ from rank 0's")
    sum_tol = 1e-4 if dtype == "float32" else CP_LOSS_TOL
    nll_tol = 2 * CP_EVAL_LOGIT_TOL[dtype] * scale
    res = {"last_ks": list(task["last_ks"]), "max|logit|": scale,
           "s_2ranks": [rk[idx]["s"] for rk in ranks], "s_1rank": ref_s,
           "launches": ranks[0][idx]["launches"], "per_k": []}
    for k, g, w in zip(task["last_ks"], got[0], want):
        row = {}
        for n in ("loss", "loss_sum", "acc", "last_k_loss_sum"):
            rel = abs(float(g[n]) - float(w[n])) / abs(float(w[n]))
            check(rel <= sum_tol, f"{name} k={k}: {n} {float(g[n])} vs one "
                  f"rank {float(w[n])} (rel {rel:.2e} > {sum_tol})")
            row[n] = [float(g[n]), float(w[n]), rel]
        for n in ("count", "last_k_count"):
            check(float(g[n]) == float(w[n]), f"{name} k={k}: {n} "
                  f"{float(g[n])} vs {float(w[n])}")
        check(torch.equal(g["pos_count"].float(), w["pos_count"].float()),
              f"{name} k={k}: per-position counts differ")
        e = (g["pos_nll_sum"] - w["pos_nll_sum"]).abs().max().item()
        check(e <= nll_tol, f"{name} k={k}: per-position NLL {e:.3e} > "
              f"{nll_tol:.3e}")
        row["pos_nll_max_abs_err"] = e
        row["last_k_count"] = float(w["last_k_count"])
        res["per_k"].append(row)
    for r in range(len(ranks)):
        os.remove(os.path.join(out_dir, f"{name}_{r}.pt"))
    log(f"[cp_eval] {name} ({dtype}): the eval step on {len(ranks)} CP ranks "
        f"(loss weights, per_token, last_k {list(task['last_ks'])}) vs one "
        f"rank on the card: " + "; ".join(
            f"k={k}: loss rel {r['loss'][2]:.2e}, last-k sum rel "
            f"{r['last_k_loss_sum'][2]:.2e} over {r['last_k_count']:.0f} "
            f"tokens, per-position NLL {r['pos_nll_max_abs_err']:.2e} (tol "
            f"{nll_tol:.2e})" for k, r in zip(task["last_ks"], res["per_k"]))
        + f"; {res['s_2ranks'][0]:.2f} s on the ranks, {ref_s:.2f} s on one")
    return res


def _hold_rank_embeds(task, ranks, idx, out_dir):
    """Hold the CP ``inputs_embeds`` check against the unsplit backbone on
    one rank on the card (fp32): the hidden states by the fp32 kernel rule,
    the embeddings' gradient (the ranks' columns side by side) and each
    parameter gradient within rel_l2 1e-4 and `TRAIN_TOL` grad of its
    largest element (the rank step's fp32 rule); the CP entry's launches."""
    from caduceus_tpu_torch.config import CaduceusConfig
    from caduceus_tpu_torch.kernel_check import TOL, compare

    name = task["name"]
    cfg = CaduceusConfig.load(task["config"])
    want_l = {**dict.fromkeys(_all_counts(), 0), **_cp_per_step(cfg,
                                                                cfg.n_layer)}
    for r, rk in enumerate(ranks):
        check(rk[idx]["zero_outside"], f"{name} rank {r}: embedding gradient "
              "outside its columns")
        check(rk[idx]["launches"] == want_l, f"{name} rank {r}: launches "
              f"{rk[idx]['launches']} != {want_l}")
    model = _embeds_model(task, "cuda", cp=False)
    emb, cot = _embeds_inputs(task)
    e = emb.cuda().requires_grad_(True)
    _zero_counts()
    h, _ = model.backbone(None, inputs_embeds=e)
    (h.float() * cot.cuda()).sum().backward()
    ref_h, ref_ge = h.detach().cpu(), e.grad.cpu()
    ref_g = {k: p.grad.cpu() for k, p in model.named_parameters()
             if p.grad is not None}
    del model, e, h
    gc.collect()
    torch.cuda.empty_cache()
    blobs = [torch.load(os.path.join(out_dir, f"{name}_{r}.pt"))
             for r in range(len(ranks))]
    hs = compare(torch.cat([b["h"] for b in blobs], 1), ref_h,
                 TOL[torch.float32])
    check(hs["ok"], f"{name}: hidden states {hs}")
    worst = 0.0
    pairs = [("embeddings", torch.cat([b["g_emb"] for b in blobs], 1),
              ref_ge)] + [(k, blobs[0]["grads"][k], g)
                          for k, g in ref_g.items()]
    for k, got, want in pairs:
        gs = compare(got, want, TOL[torch.float32])
        e = gs["max_abs_err"] / (gs["max_abs_ref"] + 1e-30)
        check(gs["rel_l2"] <= 1e-4 and e <= TRAIN_TOL["grad"],
              f"{name}: gradient {k}: {gs}")
        worst = max(worst, e)
    for r in range(len(ranks)):
        os.remove(os.path.join(out_dir, f"{name}_{r}.pt"))
    res = {"h": hs, "grad_err": worst, "s_2ranks": [rk[idx]["s"]
                                                     for rk in ranks],
           "launches": ranks[0][idx]["launches"]}
    log(f"[cp_train] {name}: the non-RCPS v2 backbone ({cfg.n_layer} layers "
        f"fp32, L={task['L']}) given inputs_embeds on {len(ranks)} CP ranks "
        f"vs one rank: hidden states rel_l2 {hs['rel_l2']:.2e}; gradients "
        f"of sum(h R) (embeddings and parameters) within {worst:.2e} of "
        f"their max; launches per rank {res['launches']}")
    return res


def _cfg_file(work, name, cfg):
    path = os.path.join(work, f"{name}.json")
    if isinstance(cfg, dict):     # a Hyena model's keyword arguments
        with open(path, "w") as f:
            json.dump(cfg, f)
    else:
        cfg.save(path)
    return path


def _step_task(work, name, cfg, fasta, bed, L, batch, cp, mesh_model,
               tp=False, **extra):
    hyena = isinstance(cfg, dict)
    return {"kind": "step", "name": name, "config": _cfg_file(work, name, cfg),
            "dtype": cfg["dtype"] if hyena else cfg.dtype, "fasta": fasta,
            "bed": bed, "L": L, "batch": batch, "cp": cp,
            "mesh_model": mesh_model, "seed": 2222, "out": work, "tp": tp,
            "family": "hyena" if hyena else "caduceus", **extra}


def _cli_pretrain(cfg_path, fasta, bed, run_dir, L, batch, steps, ckpt,
                  mesh_model, cp):
    argv = ["pretrain", "--fasta", fasta, "--bed", bed, "--config-path",
            cfg_path, "--run-dir", run_dir, "--max-length", str(L),
            "--batch-size", str(batch), "--max-steps", str(steps),
            "--checkpoint-every", str(ckpt), "--log-every", "1",
            "--eval-every", "1000", "--dist-backend", "gloo",
            "--mesh-model", str(mesh_model)]
    return argv + (["--context-parallel"] if cp else [])


def _cp_per_step(cfg, n_layer):
    """Launches of one CP train step on each rank (batch 1, remat span 1):
    per layer and direction the two passes' forward twice (the remat
    recompute) and their backward once; v2 through the CP entry, v1
    through the single-direction scan."""
    out = dict.fromkeys(_counts(), 0)
    if cfg.ssm_cfg.version == 2:
        out.update({"ssd_fused_cp": 2 * n_layer * 4,
                    "ssd_fused_bwd_kernel_cp": 2 * n_layer * 2,
                    "ssd_conv_bwd_kernel_cp": 2 * n_layer * 2})
    else:
        out.update({"selective_scan_fwd": 2 * n_layer * 4,
                    "selective_scan_bwd": 2 * n_layer * 2})
    return out


def _tp_per_step(cfg):
    """Launches of one micro-batch's forward + backward on each rank under
    tensor parallelism (remat span 1): v2 through the unfused kernels on
    the rank's heads (#2 / #4, or the per-head #5 / #6), two directions a
    layer; v1 as on one rank, on the rank's channels."""
    n = cfg.n_layer
    if cfg.ssm_cfg.version == 2 and _per_head(cfg):
        return {"ssd_head_fwd": 2 * n * 2, "ssd_head_bwd": 2 * n}
    if cfg.ssm_cfg.version == 2:
        return {"ssd_fwd": 2 * n * 2, "ssd_bwd": 2 * n}
    return {k: v for k, v in _per_micro_batch(cfg).items() if v}


def _hyena_per_step(task):
    """Attention launches of one Hyena micro-batch: per MHA layer one
    forward (two when the mixer is recomputed in the backward), one dK/dV
    and one dQ."""
    with open(task["config"]) as f:
        kw = json.load(f)
    a = len(kw["attn_layer_idx"])
    fwd = 2 if kw.get("checkpoint_mixer") else 1
    return {"attn_fwd": fwd * a, "attn_bwd_dkv": a, "attn_bwd_dq": a}


def phase_cp_train(work, fasta, bed):
    """[cp_train] and [cp_eval]: two ranks on one card (gloo), the sequence
    of L=262,144 sharded over them (--mesh-model 2 --context-parallel).
    The first step of v2 at 2 layers fp32, v2 `hg38_mlm_v2` at
    `CP_V2_LAYERS` layers and v1 `hg38_mlm` at 4 layers (bf16, full width,
    one sequence) against one rank's step on the same weights and batch;
    `cli.py pretrain` of
    each bf16 model for 2 steps (launches counted on each rank: the CP
    entry's kernels, not the plain versions), and `cli.py eval` of the v2
    run on two ranks against `cli.py eval` on one. Then the weighted step
    (2 layers fp32, GPN loss weights), the eval step with loss weights,
    per_token and each last_k of `CP_EVAL_LAST_KS` (2 layers fp32 and
    `CP_V2_LAYERS` bf16; `_hold_rank_eval`), and the non-RCPS backbone
    given ``inputs_embeds`` (`_hold_rank_embeds`), each against one
    rank."""
    import shutil

    from caduceus_tpu_torch import cli

    v2 = hg38_mlm_v2_config(n_layer=CP_V2_LAYERS)
    v1 = hg38_mlm_config(n_layer=4)
    tasks = [
        _step_task(work, "cp_v2_fp32", hg38_mlm_v2_config(2, "float32"),
                   fasta, bed, CP_L, 1, True, 2),
        _step_task(work, "cp_v2", v2, fasta, bed, CP_L, 1, True, 2),
        _step_task(work, "cp_v1", v1, fasta, bed, CP_L, 1, True, 2)]
    run_v2 = os.path.join(work, "cp_run_v2")
    run_v1 = os.path.join(work, "cp_run_v1")
    eval_argv = ["eval", "--fasta", fasta, "--bed", bed, "--run-dir", run_v2,
                 "--split", "valid", "--max-length", str(CP_L),
                 "--batch-size", "1", "--max-batches", "1"]
    tasks += [
        {"kind": "cli", "argv": _cli_pretrain(tasks[1]["config"], fasta, bed,
                                              run_v2, CP_L, 1, 2, 2, 2, True)},
        {"kind": "cli", "argv": _cli_pretrain(tasks[2]["config"], fasta, bed,
                                              run_v1, CP_L, 1, 2, 2, 2, True)},
        {"kind": "cli", "argv": eval_argv + [
            "--mesh-model", "2", "--context-parallel", "--dist-backend",
            "gloo"]}]
    # a weighted step; the eval step with loss weights, per_token and
    # last_k (fp32 at 2 layers, bf16 at the phase's depth); inputs_embeds
    v2_fp32 = hg38_mlm_v2_config(2, "float32")
    tasks += [
        _step_task(work, "cp_v2_fp32_weighted", v2_fp32, fasta, bed, CP_L, 1,
                   True, 2, weighted=True),
        _step_task(work, "cp_eval_fp32", v2_fp32, fasta, bed, CP_L, 1, True,
                   2, weighted=True, kind="eval",
                   last_ks=list(CP_EVAL_LAST_KS)),
        _step_task(work, "cp_eval_v2", v2, fasta, bed, CP_L, 1, True, 2,
                   weighted=True, kind="eval", last_ks=list(CP_EVAL_LAST_KS)),
        _step_task(work, "cp_embeds", dataclasses.replace(v2_fp32,
                                                          rcps=False),
                   fasta, bed, CP_L, 1, True, 2, kind="embeds")]
    ranks, secs = _launch_ranks(tasks, work, "cp_train")
    out = {"launcher_s": secs}
    for i in (0, 1, 2, 6):
        out[tasks[i]["name"]] = _hold_rank_step(tasks[i], ranks, i, work)
    for i in (7, 8):
        out[tasks[i]["name"]] = _hold_rank_eval(tasks[i], ranks, i, work)
    out["cp_embeds"] = _hold_rank_embeds(tasks[9], ranks, 9, work)
    for i, (cfg, nl, run) in ((3, (v2, CP_V2_LAYERS, run_v2)),
                              (4, (v1, 4, run_v1))):
        name = "v2" if cfg.ssm_cfg.version == 2 else "v1"
        want = {k: v * 2 for k, v in _cp_per_step(cfg, nl).items()}
        for r, rk in enumerate(ranks):
            check(rk[i]["launches"] == want, f"cp_train {name} rank {r}: "
                  f"launches {rk[i]['launches']} != {want}")
        steps, _ = _records(run)
        check(sorted(steps) == [1, 2] and all(
            math.isfinite(s["loss"]) for s in steps.values()),
            f"cp_train {name}: logged steps {steps}")
        step_s = {s: CP_L / st["tokens_per_sec"] for s, st in steps.items()}
        out[f"cli_{name}"] = {
            "step_s": step_s, "peak_bytes": [rk[i]["peak_bytes"]
                                             for rk in ranks],
            "launches_per_rank": ranks[0][i]["launches"],
            "steps": steps}
        log(f"[cp_train] cli.py pretrain {name} ({nl} layers, L={CP_L}, one "
            f"sequence, --mesh-model 2 --context-parallel, gloo): steps "
            f"{', '.join(f'{v:.2f}' for v in step_s.values())} s (two ranks "
            f"time-sharing one card, not a speedup across cards); loss "
            f"{[round(s['loss'], 4) for s in steps.values()]}; peak "
            f"{', '.join(f'{r[i]['peak_bytes'] / 2**30:.2f}' for r in ranks)}"
            f" GiB per rank; launches per rank {ranks[0][i]['launches']}")
    # [cp_eval]: the same checkpoint scored on one rank
    ev2 = json.loads(ranks[0][5]["stdout"].strip().splitlines()[-1])
    import io

    buf = io.StringIO()
    _zero_counts()
    with contextlib.redirect_stdout(buf):
        cli.main(eval_argv)
    ev1 = json.loads(buf.getvalue().strip().splitlines()[-1])
    check(set(ev2) == set(ev1) and all(math.isfinite(v) for v in ev2.values()),
          f"cp_eval: {ev2} vs {ev1}")
    rel = abs(ev2["valid/loss"] - ev1["valid/loss"]) / abs(ev1["valid/loss"])
    check(rel <= CP_LOSS_TOL, f"cp_eval loss {ev2} vs one rank {ev1}")
    want = {k: 0 for k in _counts()}
    want["ssd_fused_cp"] = 2 * CP_V2_LAYERS * 2
    for r, rk in enumerate(ranks):
        check(rk[5]["launches"] == want, f"cp_eval rank {r}: launches "
              f"{rk[5]['launches']} != {want}")
    out["eval"] = {"two_ranks": ev2, "one_rank": ev1, "loss_rel": rel,
                   "s": ranks[0][5]["s"],
                   "peak_bytes": [rk[5]["peak_bytes"] for rk in ranks]}
    log(f"[cp_eval] cli.py eval of the v2 run at L={CP_L}, two ranks "
        f"(context parallel) {ev2} vs one rank {ev1} (loss rel {rel:.2e}); "
        f"{ranks[0][5]['s']:.1f} s on two ranks time-sharing one card")
    shutil.rmtree(run_v1, ignore_errors=True)
    return out


def phase_dp_train(work, fasta, bed):
    """[dp_train]: two ranks on one card (gloo), data parallelism over a
    global batch of 2 sequences of 131,072: the first step at 2 layers fp32
    (also with GPN loss weights) and at `CP_V2_LAYERS` layers bf16 against
    one rank's step on the same batch (loss and updated parameters);
    `cli.py pretrain` at that depth
    for 2 steps with a checkpoint each, and, in the same job, from a copy of
    that run with only checkpoint 1, ``--resume``: step 2's log record,
    parameters and optimizer state equal the first run's bit for bit."""
    import shutil

    v2 = hg38_mlm_v2_config(n_layer=CP_V2_LAYERS)
    tasks = [
        _step_task(work, "dp_v2_fp32", hg38_mlm_v2_config(2, "float32"),
                   fasta, bed, DP_L, 2, False, 1),
        _step_task(work, "dp_v2", v2, fasta, bed, DP_L, 2, False, 1)]
    run_d = os.path.join(work, "dp_run")
    argv = _cli_pretrain(tasks[1]["config"], fasta, bed, run_d, DP_L, 2, 2, 1,
                         1, False)
    tasks.append({"kind": "cli", "argv": argv})
    tasks += _resume_tasks(run_d, argv)
    weighted = len(tasks)
    tasks.append(_step_task(work, "dp_v2_fp32_weighted",
                            hg38_mlm_v2_config(2, "float32"), fasta, bed,
                            DP_L, 2, False, 1, weighted=True))
    ranks, secs = _launch_ranks(tasks, work, "dp_train")
    out = {"launcher_s": secs}
    for i in (0, 1, weighted):
        out[tasks[i]["name"]] = _hold_rank_step(tasks[i], ranks, i, work)
    want = {k: v * 2 for k, v in _per_micro_batch(v2).items()}
    for r, rk in enumerate(ranks):
        check(rk[2]["launches"] == want, f"dp_train rank {r}: launches "
              f"{rk[2]['launches']} != {want}")
    steps_d = _hold_resume("dp_train", run_d)
    secs_r = ranks[0][4]["s"]
    step_s = {s: 2 * DP_L / st["tokens_per_sec"] for s, st in steps_d.items()}
    out["cli"] = {"step_s": step_s, "steps": steps_d,
                  "peak_bytes": [rk[2]["peak_bytes"] for rk in ranks],
                  "launches_per_rank": ranks[0][2]["launches"],
                  "resume_s": secs_r}
    log(f"[dp_train] cli.py pretrain v2 {CP_V2_LAYERS} layers, data "
        f"parallel over 2 "
        f"ranks (gloo, one card), global batch 2 x {DP_L}: steps "
        f"{', '.join(f'{v:.2f}' for v in step_s.values())} s (two ranks "
        f"time-sharing one card); resumed from checkpoint 1: step 2's record, "
        f"parameters and optimizer state equal bit for bit; peak "
        f"{', '.join(f'{r[2]['peak_bytes'] / 2**30:.2f}' for r in ranks)} GiB "
        f"per rank")
    shutil.rmtree(run_d, ignore_errors=True)
    shutil.rmtree(run_d + "_resumed", ignore_errors=True)
    return out


# -- tensor parallelism: the kernels at one rank's shapes, TP and CP x TP on
# gloo ranks that share this card, VEP over several processes ---------------

TP_M = 2                        # the model axis of [tp_train] and [cp_tp]
# gloo moves every exchanged activation through host memory (an fp32
# (G, L, 256) tensor a few times a layer), so the steps keep to one
# sequence (G = 2 with RCPS) and v2 to 4 layers (PERF.md §5 has the
# seconds at 16 and 8)
TP_L, TP_BATCH = 131072, 1
TP_V2_LAYERS = 4
TP_HY_BATCH = 2                 # the Hyena LM: G = 2 at L = 65,536
CPTP_L = 2 * CP_L_LOC           # [cp_tp]: one sequence over 2 seq ranks
# [cp_tp] gradients against one rank's (bf16 at 4 layers: two bf16
# evaluations of the same sums; fp32: the kernels' order only)
CPTP_GRAD_TOL = {"float32": {"rel_l2": 1e-4, "max": 1e-4},
                 "bfloat16": {"rel_l2": 2e-2, "max": 5e-2}}


def _tp_time(label, kernel_fn, plain_fn, bound, check_out):
    t = _timed(kernel_fn, plain_fn)
    t.update(bound)
    t["check"] = check_out
    t["max_abs_err"] = max(c["max_abs_err"] for c in check_out.values())
    log(f"[tp_kernels] time {label}: {t['ms']:.3f} ms (runs "
        f"{', '.join(f'{x:.3f}' for x in t['kernel_ms_runs'])}), bound "
        f"{t['bound_ms']:.3f} ms ({t['bound_by']}: {t['bytes'] / 1e9:.3f} "
        f"GB, {t['flops'] / 1e12:.3f} TFLOP), plain {t['plain_ms']:.1f} ms")
    return t


def phase_tp_kernels():
    """[tp_kernels] the kernels of the tensor-parallel paths at one rank's
    shapes (model axis 2: half the channels or heads), forward direction,
    each held against its plain version by the rule of kernel_check.py and
    timed beside its bound and its plain version: #9 `bidir_scan_fwd`, #7
    `selective_scan_fwd` and #8 `selective_scan_bwd` (G=4, L=131072, 256
    channels, N=16), #2 `ssd_fwd` and #4 `ssd_bwd` (K = 0: G=4, L=131072,
    H=4, P=64, NG=1, N=128; x, B, C column views of the rank's conv
    output), the per-head #5 / #6 on the same inputs, the CP entry of #1 /
    #3a / #3b (G=2, L_loc=131072, H=4: one rank's lanes, edge_hist) and #11
    (G=2, L=65536, H=4, hd=32, causal, q / k / v views of the rank's
    packed Wqkv output)."""
    from caduceus_tpu_torch.kernel_check import TOL, compare
    from caduceus_tpu_torch.ops import attention as A
    from caduceus_tpu_torch.ops import scan, ssd_head
    from caduceus_tpu_torch.ops import selective_scan as plain_scan
    from caduceus_tpu_torch.ops.ssd import ssd_chunked, ssd_chunked_bwd
    from caduceus_tpu_torch.ops.ssd_batched import (KERNEL_CHUNK, ssd_bwd,
                                                    ssd_fwd)

    bf16 = TOL[torch.bfloat16]
    out = {}
    G, L = 4, TP_L
    # v1: one rank's 256 of the 512 channels
    d, N = 512 // TP_M, 16
    Ts = scan.KERNEL_CHUNK
    f = scan_inputs(G, L, d, N, torch.bfloat16, 1501, model_like=True)
    r = scan_inputs(G, L, d, N, torch.bfloat16, 1502, model_like=True)
    shape = f"G={G} L={L} d={d} N={N} bf16"
    k_, p_ = bidir_pair(f, r)
    chk = hold(f"bidir_scan_fwd {shape}", bf16, k_, p_,
               ("yf", "cf", "yr", "cr"), tag="tp_kernels")
    del k_, p_
    fa, ra = _scan_args(f), _scan_args(r)
    sb_ = _scan_bounds(G, L, d, N, Ts)
    out["bidir_scan_fwd"] = _tp_time(
        f"bidir_scan_fwd {shape}",
        lambda: scan.bidir_scan_fwd(*fa[:2], *fa[3:5], *ra[:2], *ra[3:5],
                                    fa[2], ra[2], fa[5], ra[5], fa[6], ra[6],
                                    save_carries=True),
        lambda: (plain_scan.selective_scan(*fa, True, False, Ts,
                                           return_carries=True),
                 plain_scan.selective_scan(*ra, True, True, Ts,
                                           return_carries=True)),
        sb_["bidir_scan_fwd"], chk)
    k_, p_ = scan_pair(f, False)
    chk = hold(f"selective_scan_fwd {shape}", bf16, k_, p_, SCAN_FWD_NAMES,
               tag="tp_kernels")
    del k_, p_
    rows, nc = G * L, -(-L // Ts)
    out["selective_scan_fwd"] = _tp_time(
        f"selective_scan_fwd {shape}",
        lambda: scan.selective_scan_fwd(*fa, True, False, Ts, None,
                                        save_carries=True),
        lambda: plain_scan.selective_scan(*fa, True, False, Ts,
                                          return_carries=True),
        _bound(rows * (2 * d * 2 + 2 * N * 2 + d * 2) + G * nc * d * N * 4,
               5 * rows * d * N, FP32_FLOP_PER_S), chk)
    k_, p_ = scan_bwd_pair(f, False)
    chk = hold(f"selective_scan_bwd {shape}", bf16, k_, p_, SCAN_BWD_NAMES,
               tag="tp_kernels")
    del k_, p_
    _, _, car = scan.selective_scan_fwd(*fa, True, False, Ts, f["h0"],
                                        save_carries=True)
    out["selective_scan_bwd"] = _tp_time(
        f"selective_scan_bwd {shape}",
        lambda: scan.bwd_call(*fa, f["g_y"], car, f["g_hN"], True, False,
                              Ts),
        lambda: plain_scan.selective_scan_bwd(*fa, f["g_y"], car, f["g_hN"],
                                              True, False, Ts),
        sb_["selective_scan_bwd"], chk)
    del f, r, fa, ra, car
    gc.collect()
    torch.cuda.empty_cache()

    # v2, the unfused SSD on one rank's 4 of the 8 heads
    H, P, NG, Nd = 8 // TP_M, 64, 1, 128
    T = KERNEL_CHUNK[torch.bfloat16]
    shape = f"G={G} L={L} H={H} P={P} NG={NG} N={Nd} bf16"
    inp = unfused_inputs(G, L, H, P, NG, Nd, torch.bfloat16, 1503, pad=16)
    k_, p_ = unfused_pair(inp, False)
    chk = hold(f"ssd_fwd {shape}", bf16, k_, p_, tag="tp_kernels")
    car = k_[2]
    del k_, p_
    a = _unfused_args(inp)
    nc = -(-L // T)
    car_bytes = G * nc * H * Nd * P * 2
    fwd_bound = _bound(
        rows * (H * P + 2 * NG * Nd + H) * 2 + rows * H * P * 2 + car_bytes
        + G * H * Nd * P * 4,
        rows * (2 * T * Nd * NG + 2 * T * P * H + 4 * Nd * P * H))
    out["ssd_fwd"] = _tp_time(
        f"ssd_fwd {shape}",
        lambda: ssd_fwd(*a, True, False, T, None, True),
        lambda: ssd_chunked(*a, True, False, T, None, return_carries=True),
        fwd_bound, chk)
    k_ = ssd_head.ssd_head_fwd(*a, True, False, T, inp["h_init"], True)
    p_ = ssd_chunked(*a, True, False, T, inp["h_init"], return_carries=True)
    chk = hold(f"ssd_head_fwd {shape}", bf16, k_, p_, tag="tp_kernels")
    del k_, p_
    out["ssd_head_fwd"] = _tp_time(
        f"ssd_head_fwd {shape}",
        lambda: ssd_head.ssd_head_fwd(*a, True, False, T, None, True),
        lambda: ssd_chunked(*a, True, False, T, None, return_carries=True),
        fwd_bound, chk)
    k_, p_ = unfused_bwd_pair(inp, False)
    chk = hold(f"ssd_bwd {shape}", bf16, k_, p_, UNFUSED_BWD_NAMES,
               tag="tp_kernels")
    del k_, p_
    bwd_args = a + [inp["g_y"], car, inp["g_hN"], True, False, T]
    bwd_bound = _bound(rows * ((H * P + 2 * NG * Nd + H) * 2 + H * P * 2)
                       + car_bytes + rows * (H * P + H + 2 * NG * Nd) * 2
                       + G * H * Nd * P * 4,
                       rows * (6 * T * Nd * NG
                               + H * (4 * T * P + 12 * Nd * P)))
    out["ssd_bwd"] = _tp_time(f"ssd_bwd {shape}",
                              lambda: ssd_bwd(*bwd_args),
                              lambda: ssd_chunked_bwd(*bwd_args),
                              bwd_bound, chk)
    k_ = ssd_head.ssd_head_bwd(*bwd_args)
    p_ = ssd_chunked_bwd(*bwd_args)
    chk = hold(f"ssd_head_bwd {shape}", bf16, k_, p_, UNFUSED_BWD_NAMES,
               tag="tp_kernels")
    del k_, p_
    out["ssd_head_bwd"] = _tp_time(f"ssd_head_bwd {shape}",
                                   lambda: ssd_head.ssd_head_bwd(*bwd_args),
                                   lambda: ssd_chunked_bwd(*bwd_args),
                                   bwd_bound, chk)
    del inp, a, car, bwd_args
    gc.collect()
    torch.cuda.empty_cache()

    # the CP entry on one rank's lanes: 4 heads and the B / C lanes
    sh = ssd_inputs(CP_G, CP_L_LOC, H, P, NG, Nd, 4, torch.bfloat16, 1504)
    edge = sh["xBC"][:, :8].flip(1).contiguous()
    (fk, fp), (bk, bp) = cp_entry_pair(sh, False, edge)
    et = f"G={CP_G} L={CP_L_LOC} H={H} bf16"
    out["cp_entry"] = {
        "fwd": hold(f"CP entry vs plain, {et}", bf16, fk, fp,
                    tag="tp_kernels"),
        "bwd": hold(f"CP entry adjoint vs plain, {et}", bf16, bk, bp,
                    names=CP_NAMES, tag="tp_kernels")}
    del sh, fk, fp, bk, bp
    gc.collect()
    torch.cuda.empty_cache()
    out["cp_timing"] = _cp_timing(H=H)

    # #11 at one rank's 4 of the 8 heads, q / k / v views of one packed
    # (G, L, 3 H hd) tensor
    Ga, La, Ha, hd = ATTN_G, ATTN_L, ATTN_H // TP_M, ATTN_HD
    label = f"G={Ga} L={La} H={Ha} hd={hd} bf16 causal"
    q, k, v, do = _attn_inputs(torch.bfloat16, Ga, La, Ha, hd, seed=1505,
                               packed=True)
    got, plain = _attn_pair(q, k, v, do, True)
    st = _attn_hold(label, got, plain)
    checks = {n: {k2: st[n][k2] for k2 in ("rel_l2", "max_abs_err",
                                           "max_abs_ref", "atol_needed")}
              for n in st}
    log(f"[tp_kernels] attention {label}: pass against the chunked plain "
        f"version")
    del got, plain
    sc = hd ** -0.5
    o, lse = A.attention_fwd(q, k, v, True, sc)
    _, _, D = A.attention_bwd_dkv(q, k, v, o, lse, do, True, sc)
    out["attn"], _, _ = _attn_timing(q, k, v, do, o, lse, D, label, checks)
    del q, k, v, do, o, lse, D
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _hy_kw():
    """configs/hg38_hyena.yaml's model (8 layers, MHA at `HY_ATTN` with 8
    heads), dropout off (no dropout key in the step), each block's mixer
    and MLP recomputed in the backward."""
    return dict(d_model=256, n_layer=HY_LAYERS, vocab_size=12, l_max=HY_L,
                attn_layer_idx=list(HY_ATTN), num_heads=8, dtype="bfloat16",
                checkpoint_mixer=True, checkpoint_mlp=True)


def _resume_tasks(run_d, argv):
    """Rank-job tasks after ``argv`` (`cli.py pretrain` of ``run_d`` for 2
    steps, a checkpoint each): a copy of the run cut back to checkpoint 1
    (rank 0 makes it, every rank waits), then ``argv`` + --resume on it."""
    run_r = run_d + "_resumed"
    return [{"kind": "cut_run", "src": run_d, "dst": run_r},
            {"kind": "cli",
             "argv": [run_r if a == run_d else a for a in argv]
             + ["--resume"]}]


def _cut_run(src, dst):
    """A copy of the run dir ``src`` at ``dst`` that ends at checkpoint 1."""
    import shutil

    from caduceus_tpu_torch.train import checkpoint

    shutil.copytree(src, dst)
    shutil.rmtree(os.path.join(dst, "checkpoints", "2"))
    with open(os.path.join(dst, "metrics.jsonl")) as f:
        keep = [ln for ln in f if json.loads(ln).get("step", 0) < 2]
    with open(os.path.join(dst, "metrics.jsonl"), "w") as f:
        f.writelines(keep)
    check(checkpoint.latest_step(os.path.join(dst, "checkpoints")) == 1,
          f"{dst}: the copy does not end at checkpoint 1")


def _hold_resume(name, run_d):
    """The run resumed from checkpoint 1 (`_resume_tasks`) against the
    first: step 2's log record, parameters and optimizer state equal bit
    for bit; returns the first run's logged steps."""
    run_r = run_d + "_resumed"
    steps_d, _ = _records(run_d)
    steps_r, _ = _records(run_r)
    for k in ("loss", "acc", "grad_norm", "lr"):
        check(steps_d[2][k] == steps_r[2][k], f"{name} resume: step 2 "
              f"{k} {steps_r[2][k]!r} != {steps_d[2][k]!r}")
    za = np.load(os.path.join(run_d, "checkpoints", "2", "params.npz"))
    zb = np.load(os.path.join(run_r, "checkpoints", "2", "params.npz"))
    for k in za.files:
        check(np.array_equal(za[k], zb[k]), f"{name} resume params {k}")
    oa = torch.load(os.path.join(run_d, "checkpoints", "2", "optimizer.pt"))
    ob = torch.load(os.path.join(run_r, "checkpoints", "2", "optimizer.pt"))
    check(oa["count"] == ob["count"], f"{name} resume: optimizer count")
    for sa, sb_ in zip(oa["adamw"]["state"].values(),
                       ob["adamw"]["state"].values()):
        for k in sa:
            check(torch.equal(torch.as_tensor(sa[k]), torch.as_tensor(sb_[k])),
                  f"{name} resume: optimizer {k}")
    return steps_d


def phase_tp_train(work, fasta, bed, vep_run):
    """[tp_train]: two ranks on one card (gloo), the model cut over them
    (--mesh-model 2 --tensor-parallel). The first step of v2 at 2 layers
    fp32, v2 `hg38_mlm_v2` at `TP_V2_LAYERS` layers and v1 `hg38_mlm` at 4
    layers (bf16; full width, L=131072, one sequence: G=2 with RCPS) and of
    the Hyena LM at configs/hg38_hyena.yaml's width (8 layers, MHA at 1 and
    5, L=65536, 2 sequences, dropout off) against one rank's step on the same weights
    and batch (`_hold_rank_step`; every model rank's shared gradients
    equal); `cli.py pretrain` of v2 for 2 steps with a checkpoint each, its
    resume from checkpoint 1 replaying step 2 bit for bit; `cli.py eval` of
    that run dir on two ranks against one rank; [vep_ranks] (`cli.py vep`
    of ``vep_run`` = [vep]'s run dir, in the same job). The kernels'
    launches are counted on each rank."""
    import shutil

    from caduceus_tpu_torch import cli

    v2 = hg38_mlm_v2_config(n_layer=TP_V2_LAYERS)
    tasks = [
        _step_task(work, "tp_v2_fp32", hg38_mlm_v2_config(2, "float32"),
                   fasta, bed, TP_L, TP_BATCH, False, TP_M, tp=True),
        _step_task(work, "tp_v2", v2, fasta, bed, TP_L, TP_BATCH, False,
                   TP_M, tp=True),
        _step_task(work, "tp_v1", hg38_mlm_config(n_layer=4), fasta, bed,
                   TP_L, TP_BATCH, False, TP_M, tp=True),
        _step_task(work, "tp_hyena", _hy_kw(), fasta, bed, HY_L,
                   TP_HY_BATCH, False, TP_M, tp=True)]
    run_t = os.path.join(work, "tp_run")
    argv = _cli_pretrain(tasks[1]["config"], fasta, bed, run_t, TP_L,
                         TP_BATCH, 2, 1, TP_M, False) + ["--tensor-parallel"]
    eval_argv = ["eval", "--fasta", fasta, "--bed", bed, "--run-dir", run_t,
                 "--split", "valid", "--max-length", str(TP_L),
                 "--batch-size", str(TP_BATCH), "--max-batches", "1"]
    # 4: pretrain, 5-6: its resume from checkpoint 1, 7: eval, 8: vep
    tasks += ([{"kind": "cli", "argv": argv}] + _resume_tasks(run_t, argv)
              + [{"kind": "cli", "argv": eval_argv + [
                  "--mesh-model", str(TP_M), "--tensor-parallel",
                  "--dist-backend", "gloo"]},
                 _vep_ranks_task(work, fasta, vep_run, "hg38_mlm_v2")])
    ranks, secs = _launch_ranks(tasks, work, "tp_train")
    out = {"launcher_s": secs,
           "vep_ranks": _hold_vep_ranks(work, "hg38_mlm_v2",
                                        [rk[8] for rk in ranks])}
    for i in range(4):
        out[tasks[i]["name"]] = _hold_rank_step(tasks[i], ranks, i, work)
    want = {**dict.fromkeys(_counts(), 0),
            **{k: v * 2 for k, v in _tp_per_step(v2).items()}}
    for r, rk in enumerate(ranks):
        check(rk[4]["launches"] == want, f"tp_train cli rank {r}: launches "
              f"{rk[4]['launches']} != {want}")
    with open(os.path.join(run_t, "model_config.json")) as f:
        check(json.load(f)["tensor_parallel_axis"] is None,
              "tp_train: model_config.json records a tensor_parallel_axis")
    steps, _ = _records(run_t)
    check(sorted(steps) == [1, 2] and all(
        math.isfinite(s["loss"]) for s in steps.values()),
        f"tp_train cli: logged steps {steps}")
    step_s = {s: TP_BATCH * TP_L / st["tokens_per_sec"]
              for s, st in steps.items()}
    out["cli"] = {"step_s": step_s, "steps": steps,
                  "peak_bytes": [rk[4]["peak_bytes"] for rk in ranks],
                  "launches_per_rank": ranks[0][4]["launches"]}
    log(f"[tp_train] cli.py pretrain v2 {TP_V2_LAYERS} layers, L={TP_L}, "
        f"{TP_BATCH} sequences, --mesh-model 2 --tensor-parallel (gloo, one "
        f"card): steps {', '.join(f'{v:.2f}' for v in step_s.values())} s "
        f"(two ranks time-sharing one card, not a speedup across cards); "
        f"peak {', '.join(f'{r[4]['peak_bytes'] / 2**30:.2f}' for r in ranks)}"
        f" GiB per rank; launches per rank {ranks[0][4]['launches']}")
    _hold_resume("tp_train", run_t)
    out["cli"]["resume_s"] = ranks[0][6]["s"]
    log("[tp_train] resumed from checkpoint 1 on two ranks: step 2's record, "
        "parameters and optimizer state equal bit for bit")
    # [tp_train] eval: the run dir on one rank against two
    ev2 = json.loads(ranks[0][7]["stdout"].strip().splitlines()[-1])
    buf = io.StringIO()
    _zero_counts()
    with contextlib.redirect_stdout(buf):
        cli.main(eval_argv)
    ev1 = json.loads(buf.getvalue().strip().splitlines()[-1])
    check(set(ev2) == set(ev1) and all(math.isfinite(v) for v in ev2.values()),
          f"tp_train eval: {ev2} vs {ev1}")
    rel = abs(ev2["valid/loss"] - ev1["valid/loss"]) / abs(ev1["valid/loss"])
    check(rel <= CP_LOSS_TOL, f"tp_train eval loss {ev2} vs one rank {ev1}")
    want = {**dict.fromkeys(_counts(), 0), "ssd_fwd": 2 * TP_V2_LAYERS}
    for r, rk in enumerate(ranks):
        check(rk[7]["launches"] == want, f"tp_train eval rank {r}: launches "
              f"{rk[7]['launches']} != {want}")
    out["eval"] = {"two_ranks": ev2, "one_rank": ev1, "loss_rel": rel,
                   "s": ranks[0][7]["s"]}
    log(f"[tp_train] cli.py eval of the run at L={TP_L}, two ranks (tensor "
        f"parallel) {ev2} vs one rank {ev1} (loss rel {rel:.2e})")
    shutil.rmtree(run_t, ignore_errors=True)
    shutil.rmtree(run_t + "_resumed", ignore_errors=True)
    return out


def _hold_grads(label, got, want, dtype):
    """Each gradient against one rank's: rel_l2 and max |err| / max |ref|
    within `CPTP_GRAD_TOL`; returns the worst of each."""
    tol = CPTP_GRAD_TOL[dtype]
    worst = {"rel_l2": 0.0, "max": 0.0}
    for n, g in want.items():
        a, b = got[n].double(), g.double()
        rel = ((a - b).norm() / b.norm().clamp(min=1e-30)).item()
        mx = ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
        check(rel <= tol["rel_l2"] and mx <= tol["max"],
              f"{label}: gradient {n}: rel_l2 {rel:.2e}, max {mx:.2e} "
              f"(tol {tol})")
        worst = {"rel_l2": max(worst["rel_l2"], rel),
                 "max": max(worst["max"], mx)}
    return worst


def phase_cp_tp(work):
    """[cp_tp]: four ranks on one card (gloo), a (data 1, model 2, seq 2)
    grid: v2 with tensor_parallel_axis "model" (4 heads a rank) and
    context_parallel_axis "seq". One sequence of `CPTP_L` rows at 4 layers
    bf16 (L_loc = 131,072: the fused route, the CP entry at H = 4 lanes),
    then 2 layers fp32 at L = 2 x 2048 (fused) and at L = 2 x 1536 (the
    unfused composed route: a shard of 1,536 rows is not a multiple of the
    CP entry's 1,024-row segment); the forward and the parameter gradients
    of sum(logits^2), gathered, against one rank's unsharded model on the
    same weights; each rank's launches counted."""
    cases = [("cptp_v2", hg38_mlm_v2_config(4), CPTP_L, "fused"),
             ("cptp_v2_fp32", hg38_mlm_v2_config(2, "float32"), 2 * 2048,
              "fused"),
             ("cptp_v2_unfused", hg38_mlm_v2_config(2, "float32"), 2 * 1536,
              "unfused")]
    tasks = [{"kind": "grad", "name": name, "config": _cfg_file(work, name,
                                                                cfg),
              "L": L, "seed": 2222, "out": work, "mesh_model": TP_M,
              "seq": 2, "cp": True, "tp": True, "route": route}
             for name, cfg, L, route in cases]
    ranks, secs = _launch_ranks(tasks, work, "cp_tp", n=TP_M * 2)
    out = {"launcher_s": secs}
    for i, (name, cfg, L, route) in enumerate(cases):
        n = cfg.n_layer
        want = dict.fromkeys(_all_counts(), 0)
        if route == "fused":
            want.update({"ssd_fused_cp": 2 * n * 4,
                         "ssd_fused_bwd_kernel_cp": 2 * n * 2,
                         "ssd_conv_bwd_kernel_cp": 2 * n * 2})
        else:
            want.update({"ssd_fwd": 2 * n * 4, "ssd_bwd": 2 * n * 2})
        for r, rk in enumerate(ranks):
            check(rk[i]["launches"] == want, f"{name} rank {r}: launches "
                  f"{rk[i]['launches']} != {want}")
        blobs = [torch.load(os.path.join(work, f"{name}_{r}.pt"))
                 for r in range(len(ranks))]
        # rank r = m * 2 + s: the model ranks of a seq shard hold the same
        # logits; the seq shards are its columns
        for r in range(len(ranks)):
            check(torch.equal(blobs[r]["logits"], blobs[r % 2]["logits"]),
                  f"{name}: model ranks' logits differ")
        logits = torch.cat([blobs[0]["logits"], blobs[1]["logits"]], 1)
        model = _task_model(tasks[i], "cuda", parallel=False)
        ref = model(_grad_ids(tasks[i]).cuda())
        ref.float().square().sum().backward()
        grads = {k: p.grad.detach().cpu() for k, p in
                 model.named_parameters()}
        ref = ref.detach().cpu()
        del model
        gc.collect()
        torch.cuda.empty_cache()
        e = ((logits - ref).abs().max() / ref.abs().max()).item()
        lim = BF16_MODEL_TOL if cfg.dtype == "bfloat16" else 1e-5
        check(e <= lim, f"{name}: logits {e:.2e} of max|logit| > {lim}")
        worst = _hold_grads(name, blobs[0]["grads"], grads, cfg.dtype)
        out[name] = {"logits_err": e, "grad_err": worst, "route": route,
                     "s": [rk[i]["s"] for rk in ranks],
                     "peak_bytes": [rk[i]["peak_bytes"] for rk in ranks],
                     "launches": ranks[0][i]["launches"]}
        for r in range(len(ranks)):
            os.remove(os.path.join(work, f"{name}_{r}.pt"))
        log(f"[cp_tp] {name} ({n} layers {cfg.dtype}, L={L}, {route} route, "
            f"data 1 x model 2 x seq 2 on one card): logits {e:.2e} of "
            f"max|logit|, gradients worst rel_l2 {worst['rel_l2']:.2e}, max "
            f"{worst['max']:.2e} of max|g| against one rank; forward + "
            f"backward {', '.join(f'{x:.2f}' for x in out[name]['s'])} s per "
            f"rank; peak "
            f"{', '.join(f'{b / 2**30:.2f}' for b in out[name]['peak_bytes'])}"
            f" GiB; launches per rank {ranks[0][i]['launches']}")
    return out


def _vep_ranks_task(work, fasta, run_dir, name):
    """[vep_ranks]' task: `cli.py vep` of [vep]'s run dir and variants, run
    by the ranks of [tp_train]'s job."""
    argv = ["vep", "--fasta", fasta, "--variants",
            os.path.join(work, f"variants_{name}.tsv"), "--run-dir", run_dir,
            "--out", os.path.join(work, f"vep_ranks_{name}"), "--seq-len",
            str(VEP_L), "--batch-size", str(VEP_BATCH)]
    return {"kind": "cli", "argv": argv}


def _hold_vep_ranks(work, name, res):
    """[vep_ranks] `cli.py vep` under `torch.distributed.run
    --nproc_per_node 2` (gloo, one card; ``res``: each rank's result):
    each rank dumps variants[rank::2], the ranks meet at a barrier, rank 0
    combines. Every row of the combined file (rank-major order) against
    [vep]'s one-rank row of the same variant by the bf16 rule of
    kernel_check.py, labels and TSS distances equal; the peak-memory line
    printed once, the combine on rank 0 alone."""
    from caduceus_tpu_torch.kernel_check import TOL, compare

    variants = os.path.join(work, f"variants_{name}.tsv")
    one = np.load(os.path.join(work, f"vep_{name}.npz"))
    two = np.load(os.path.join(work, f"vep_ranks_{name}.npz"))
    with open(variants) as f:
        n_rows = sum(1 for ln in f if ln.strip())
    kept = [i for i in range(n_rows) if i != 3]   # row 3: a wrong ref base
    order = [kept.index(i) for r in range(2) for i in range(r, n_rows, 2)
             if i != 3]
    check(two["features"].shape == one["features"].shape,
          f"vep_ranks: {two['features'].shape} vs {one['features'].shape}")
    check(np.array_equal(two["labels"], one["labels"][order])
          and np.array_equal(two["tss_distance"], one["tss_distance"][order]),
          "vep_ranks: labels / TSS distances out of order")
    worst = 0.0
    for j, i in enumerate(order):
        st = compare(torch.from_numpy(two["features"][j]),
                     torch.from_numpy(one["features"][i]),
                     TOL[torch.bfloat16])
        check(st["ok"], f"vep_ranks: variant row {i}: {st}")
        worst = max(worst, st["max_abs_err"])
    outs = [rk["stdout"] for rk in res]
    peaks = [sum("vep_peak_hbm_gib" in ln for ln in o.splitlines())
             for o in outs]
    check(peaks == [1, 0], f"vep_ranks: peak lines per rank {peaks}")
    check(any("embeddings" in ln for ln in outs[0].splitlines())
          and not any("embeddings" in ln for ln in outs[1].splitlines()),
          "vep_ranks: rank 0 alone combines")
    out = {"s": [rk["s"] for rk in res], "max_abs_err": worst,
           "launches": [rk["launches"] for rk in res],
           "peak_bytes": [rk["peak_bytes"] for rk in res]}
    log(f"[vep_ranks] cli.py vep over 2 processes (gloo barrier, one card), "
        f"seq_len {VEP_L}: {len(order)} rows, each within the bf16 rule of "
        f"the one-rank row of its variant (max |err| {worst:.3e}); "
        f"{', '.join(f'{x:.1f}' for x in out['s'])} s per rank; launches "
        f"per rank {[sum(x.values()) for x in out['launches']]}")
    return out


def _vep_run_dir(work):
    """A `hg38_mlm_v2` run dir (16 layers, seeded random weights) for
    ``--only tp``'s [vep] and [vep_ranks]."""
    from caduceus_tpu_torch.models.caduceus import CaduceusForMaskedLM
    from caduceus_tpu_torch.params import to_jax_params

    run = os.path.join(work, "vep_run")
    os.makedirs(run, exist_ok=True)
    cfg = hg38_mlm_v2_config(16)
    cfg.save(os.path.join(run, "model_config.json"))
    model = CaduceusForMaskedLM(cfg, device="cpu",
                                generator=torch.Generator().manual_seed(7))
    np.savez(os.path.join(run, "params.npz"),
             **to_jax_params(model.state_dict()))
    return run


def _tp_phases(report, work, fasta, bed, vep_run=None):
    """The tensor-parallel phases (the kernels are built); [vep_ranks]
    reads [vep]'s run dir and output, or makes its own (``--only tp``)."""
    t0 = time.perf_counter()
    if vep_run is None:
        vep_run = _vep_run_dir(work)
        report["vep"] = phase_vep(work, fasta, vep_run, "hg38_mlm_v2")
    report["tp_kernels"] = phase_tp_kernels()
    report["tp_train"] = phase_tp_train(work, fasta, bed, vep_run)
    report["vep_ranks"] = report["tp_train"].pop("vep_ranks")
    report["cp_tp"] = phase_cp_tp(work)
    report["tp_phase_s"] = time.perf_counter() - t0


def _tp_kernel_extras(report):
    """Per kernel of the kernels line: its time at one rank's shape under
    tensor parallelism and its launches on each rank of the TP paths."""
    tk, tt, ct = report["tp_kernels"], report["tp_train"], report["cp_tp"]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")

    def at(t, shape):
        return {"shape": shape, **{k: t[k] for k in keys if k in t}}

    scan = f"G=4 L={TP_L} d=256 N=16 bf16 (one rank of 2)"
    ssd = f"G=4 L={TP_L} H=4 P=64 NG=1 N=128 bf16 (one rank of 2)"
    cp = (f"G={CP_G} L={CP_L_LOC} H=4 bf16 with edge_hist (one rank of a "
          "data 1 x model 2 x seq 2 grid)")
    attn = (f"G={ATTN_G} L={ATTN_L} H={ATTN_H // TP_M} hd={ATTN_HD} bf16 "
            "causal (one rank of 2)")
    v1, hy = tt["tp_v1"]["launches"][0], tt["tp_hyena"]["launches"][0]
    cli = tt["cli"]["launches_per_rank"]
    cp_l = ct["cptp_v2"]["launches"]
    out = {
        "bidir_scan_fwd": {"tp": at(tk["bidir_scan_fwd"], scan),
                           "launches_tp": v1["bidir_scan_fwd"]},
        "selective_scan_bwd": {"tp": at(tk["selective_scan_bwd"], scan),
                               "launches_tp": v1["selective_scan_bwd"]},
        "selective_scan_fwd": {"tp": at(tk["selective_scan_fwd"], scan)},
        "ssd_fwd": {"tp": at(tk["ssd_fwd"], ssd),
                    "launches_tp": cli["ssd_fwd"]},
        "ssd_bwd": {"tp": at(tk["ssd_bwd"], ssd),
                    "launches_tp": cli["ssd_bwd"]},
        "ssd_head_fwd": {"tp": at(tk["ssd_head_fwd"], ssd)},
        "ssd_head_bwd": {"tp": at(tk["ssd_head_bwd"], ssd)}}
    for name, kname in (("ssd_fused_cp", "ssd_fused_fwd"),
                        ("ssd_fused_bwd_kernel_cp", "ssd_fused_bwd_kernel"),
                        ("ssd_conv_bwd_kernel_cp", "ssd_conv_bwd_kernel")):
        t = tk["cp_timing"][kname]
        out[name] = {"tp": {**at(t, cp),
                            "max_abs_err": t["check"]["max_abs_err"]},
                     "launches_tp": cp_l[name]}
    for name in ("attn_fwd", "attn_bwd_dkv", "attn_bwd_dq"):
        out[name] = {"tp": at(tk["attn"][name], attn),
                     "launches_tp": hy[name]}
    paths = {"launches_tp_paths": (
        "per rank: bidir_scan_fwd / selective_scan_bwd the v1 step "
        "(4 layers); ssd_fwd / ssd_bwd cli.py pretrain --tensor-parallel v2 "
        f"({TP_V2_LAYERS} layers, 2 steps); the CP entry the [cp_tp] v2 "
        "forward + backward (4 layers, L=262144); attention the Hyena step "
        "(8 layers, MHA at 1 and 5)")}
    return {k: {**v, **paths} for k, v in out.items()}


# -- the Hyena family: flash-attention kernels, pretrain, fine-tune -------

ATTN_NAMES = ("o", "lse", "dq", "dk", "dv")
# the path shape: one micro-batch of `cli.py pretrain --model hyena` at
# configs/hg38_hyena.yaml's width (d_model 256, 8 heads of 32)
ATTN_G, ATTN_L, ATTN_H, ATTN_HD = 2, 65536, 8, 32
HY_L, HY_BATCH, HY_ACCUM, HY_STEPS = 65536, 4, 2, 3
HY_LAYERS, HY_ATTN = 8, (1, 5)
# exps of the MUFU: 16 a clock per SM (H100 SXM: 132 SMs, 1.98 GHz boost)
EXP_PER_S = 16 * 132 * 1.98e9


def _attn_inputs(dtype, B, L, H, hd, seed, packed=False):
    """q, k, v, dO (B, L, H, hd) on the card; with ``packed`` q, k and v
    are strided views of one (B, L, 3 H hd) tensor, as `MHA.forward` splits
    its Wqkv output."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if packed:
        w = torch.randn(B, L, 3 * H * hd, generator=g, device="cuda").to(dtype)
        qkv = [t.view(B, L, H, hd) for t in w.split(H * hd, dim=-1)]
        return qkv + [torch.randn(B, L, H, hd, generator=g,
                                  device="cuda").to(dtype)]
    return [torch.randn(B, L, H, hd, generator=g, device="cuda").to(dtype)
            for _ in range(4)]


def _attn_pair(q, k, v, do, causal):
    """(kernel outputs, plain outputs) in `ATTN_NAMES` order: the forward
    kernel against `attention_fwd_plain`, the adjoint kernels (from the
    kernel's own O and lse) against `attention_bwd_plain`."""
    from caduceus_tpu_torch.ops import attention as A

    sc = q.shape[-1] ** -0.5
    o, lse = A.attention_fwd(q, k, v, causal, sc)
    got = (o, lse, *A.attention_bwd(q, k, v, o, lse, do, causal, sc))
    po, plse = A.attention_fwd_plain(q, k, v, causal, sc)
    plain = (po, plse, *A.attention_bwd_plain(q, k, v, o, lse, do, causal,
                                              sc))
    torch.cuda.synchronize()
    return got, plain


def _attn_hold(label, got, plain, expect_ok=True):
    """Each output against the plain one by the rule of kernel_check.py,
    the floor per row (`compare(rows=True)`); lse by the fp32 tolerance."""
    from caduceus_tpu_torch.kernel_check import TOL, compare, describe

    out = {}
    for name, a, b in zip(ATTN_NAMES, got, plain):
        tol = TOL[torch.float32] if name == "lse" else TOL[a.dtype]
        st = compare(a, b, tol, rows=True)
        out[name] = st
        if expect_ok:
            check(st["ok"], f"[attn_kernels] {label} {name}: {describe(st)}")
    return out


def _attn_work(G, L, H, hd, causal=True):
    """Scores, FLOPs and bytes of the three kernels' functions at (G, L, H,
    hd) in bf16: scores = G H L (L + 1) / 2 when causal; FLOPs: 4 hd a
    score in the forward (QK^T, PV), 8 in dK / dV (S, dP recomputed, P^T
    dO, dS^T Q), 6 in dQ (S, dP, dS K); one exp a score in each; bytes:
    each input read once, each output written once (bf16 rows, fp32 lse
    and D)."""
    scores = G * H * (L * (L + 1) // 2 if causal else L * L)
    t, r = G * L * H * hd * 2, G * H * L * 4
    return {"attn_fwd": (scores, 4 * hd * scores, 3 * t + t + r),
            "attn_bwd_dkv": (scores, 8 * hd * scores, 5 * t + r + 2 * t + r),
            "attn_bwd_dq": (scores, 6 * hd * scores, 4 * t + 2 * r + t)}


def _attn_polls(q, k, v, do, outputs, sc, label):
    """The three kernels once each at the path shape from the ATTN_POLLS
    probe build (its barrier wait counted): their outputs equal the shipped
    kernels' bit for bit, and the largest poll count any one wait took,
    the waits and the mean polls a wait (lane 0 of each warp), which must
    stay far from the 2^24 at which the earlier bounded wait gave up."""
    import ctypes

    from caduceus_tpu_torch import _build
    from caduceus_tpu_torch.ops import attention as A

    def read(lib):
        buf = (ctypes.c_ulonglong * 3)()
        fn = _build.load(lib, ATTN_POLLS).attn_polls
        fn.argtypes = [ctypes.c_void_p]
        err = fn(ctypes.cast(buf, ctypes.c_void_p))
        check(err == 0, f"[attn_kernels] attn_polls: CUDA error {err}")
        return {"max": buf[0], "waits": buf[1],
                "mean": buf[2] / max(buf[1], 1)}

    out = {}
    with _variant(A, ATTN_POLLS):
        read("attention_fwd"), read("attention_bwd")   # cleared
        o, lse = A.attention_fwd(q, k, v, True, sc)
        torch.cuda.synchronize()
        out["attn_fwd"] = read("attention_fwd")
        dk, dv, D = A.attention_bwd_dkv(q, k, v, o, lse, do, True, sc)
        torch.cuda.synchronize()
        out["attn_bwd_dkv"] = read("attention_bwd")
        dq = A.attention_bwd_dq(q, k, v, o, lse, do, D, True, sc)
        torch.cuda.synchronize()
        out["attn_bwd_dq"] = read("attention_bwd")
    check(all(torch.equal(a, b) for a, b in zip((o, lse, dq, dk, dv),
                                                outputs)),
          f"[attn_kernels] {label}: the poll-counting build's outputs "
          "differ from the shipped kernels'")
    for name, st in out.items():
        check(0 < st["max"] < 1 << 20, f"[attn_kernels] {name}: a barrier "
              f"wait took {st['max']} polls (2^24 = {1 << 24})")
    log(f"[attn_kernels] {label}: largest poll count of one barrier wait "
        + ", ".join(f"{n} {st['max']:,} ({st['waits']:,} waits, "
                    f"{st['mean']:.2f} polls a wait)" for n, st in out.items())
        + f"; the earlier bound was 2^24 = {1 << 24:,}; outputs equal the "
        "shipped kernels' bit for bit")
    return out


def phase_attn_kernels():
    """[attn_kernels] `attn_fwd`, `attn_bwd_dkv` and `attn_bwd_dq` against
    their plain versions: small shapes (L 251 ragged and 256 aligned, L 1000
    ragged over several 128- and 64-row tiles each way, causal and not,
    fp32 and bf16, head widths 32 and 64, and q, k, v as strided views of
    one packed tensor as `MHA` passes them) and the path
    shape (G=2, L=65536, H=8, hd=32, bf16, causal) against the chunked
    plain version; the bits of two runs; the planted fault (the second key
    tile skipped, the ATTN_DROP build) must fail, at a small shape and at
    the path shape; then each kernel timed at the path shape beside its
    bound (the larger of bytes, FLOPs and exps), its plain version and one
    SDPA call (a yardstick: `scaled_dot_product_attention`
    forward, and the backward of one such call, which the port never
    calls)."""
    from caduceus_tpu_torch.kernel_check import TOL, compare, describe
    from caduceus_tpu_torch.ops import attention as A

    out = {"small": {}}
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (True, False):
            for L, hd, packed in ((251, 32, False), (256, 64, False),
                                  (1000, 32, False), (1000, 64, False),
                                  (1000, 32, True)):
                label = (f"B=2 L={L} H=3 hd={hd} "
                         f"{'bf16' if dtype == torch.bfloat16 else 'fp32'} "
                         f"{'causal' if causal else 'full'}"
                         f"{' packed q/k/v views' if packed else ''}")
                ins = _attn_inputs(dtype, 2, L, 3, hd, seed=L + hd,
                                   packed=packed)
                if packed:
                    check(not ins[0].is_contiguous() and ins[1].stride(1)
                          == 9 * hd, f"[attn_kernels] {label}: not views")
                got, plain = _attn_pair(*ins, causal)
                st = _attn_hold(label, got, plain)
                again, _ = _attn_pair(*ins, causal)
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"[attn_kernels] {label}: two runs differ")
                out["small"][label] = {n: st[n]["rel_l2"] for n in st}
                log(f"[attn_kernels] {label}: pass, bits repeat (rel_l2 "
                    + ", ".join(f"{n} {st[n]['rel_l2']:.1e}" for n in st)
                    + ")")
    # the planted fault: the second key tile of every query tile skipped
    ins = _attn_inputs(torch.bfloat16, 1, 512, 2, 32, seed=5)
    with _variant(A, ATTN_DROP):
        got, plain = _attn_pair(*ins, True)
    st = _attn_hold("planted fault", got, plain, expect_ok=False)
    check(not st["o"]["ok"], "[attn_kernels] the skipped key tile passed: "
          + describe(st["o"]))
    out["planted_fault"] = {"o": describe(st["o"])}
    log(f"[attn_kernels] planted fault (key tile 1 skipped) fails as it "
        f"must: o {describe(st['o'])}")

    G, L, H, hd = ATTN_G, ATTN_L, ATTN_H, ATTN_HD
    label = f"G={G} L={L} H={H} hd={hd} bf16 causal"
    q, k, v, do = _attn_inputs(torch.bfloat16, G, L, H, hd, seed=7)
    t0 = time.perf_counter()
    got, plain = _attn_pair(q, k, v, do, True)
    pair_s = time.perf_counter() - t0
    st = _attn_hold(label, got, plain)
    sc = hd ** -0.5
    # the planted fault at the path shape, by the same per-row rule
    with _variant(A, ATTN_DROP):
        fo, _ = A.attention_fwd(q, k, v, True, sc)
    fst = compare(fo, plain[0], TOL[fo.dtype], rows=True)
    check(not fst["ok"], f"[attn_kernels] {label}: the skipped key tile "
          "passed: " + describe(fst))
    out["planted_fault_path"] = {"o": {k2: fst[k2] for k2 in (
        "rel_l2", "max_abs_err", "atol_needed")}}
    log(f"[attn_kernels] {label}: planted fault fails as it must: o "
        f"{describe(fst)}")
    del plain, fo
    o, lse = A.attention_fwd(q, k, v, True, sc)
    dk, dv, D = A.attention_bwd_dkv(q, k, v, o, lse, do, True, sc)
    dq = A.attention_bwd_dq(q, k, v, o, lse, do, D, True, sc)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, (o, lse, dq, dk, dv))),
          f"[attn_kernels] {label}: two runs differ")
    out["path"] = {n: {k2: st[n][k2] for k2 in (
        "rel_l2", "max_abs_err", "max_abs_ref", "atol_needed")} for n in st}
    out["polls"] = _attn_polls(q, k, v, do, (o, lse, dq, dk, dv), sc, label)
    log(f"[attn_kernels] {label}: pass against the chunked plain version "
        f"({pair_s:.1f} s for both sides), bits repeat: "
        + "; ".join(f"{n} {describe(st[n])}" for n in st))
    del got

    out["timing"], sdpa_fwd, sdpa_bwd = _attn_timing(
        q, k, v, do, o, lse, D, label, out["path"])
    # the redesign's targets: the forward against one SDPA forward and
    # twice its exp bound, the adjoint pair against one SDPA backward
    tm = out["timing"]
    pair = tm["attn_bwd_dkv"]["ms"] + tm["attn_bwd_dq"]["ms"]
    out["targets"] = {
        "fwd_over_sdpa_fwd": tm["attn_fwd"]["ms"] / sdpa_fwd,
        "fwd_over_exp_bound": tm["attn_fwd"]["ms"] / tm["attn_fwd"]["exp_ms"],
        "pair_ms": pair, "pair_over_sdpa_bwd": pair / sdpa_bwd}
    log(f"[attn_kernels] targets: attn_fwd {tm['attn_fwd']['ms']:.3f} ms = "
        f"{out['targets']['fwd_over_sdpa_fwd']:.3f} x SDPA forward, "
        f"{out['targets']['fwd_over_exp_bound']:.3f} x its exp bound "
        f"(target <= 1 and <= 2); dK/dV + dQ {pair:.3f} ms = "
        f"{out['targets']['pair_over_sdpa_bwd']:.3f} x SDPA backward "
        "(target <= 1)")
    del q, k, v, do, o, lse, dk, dv, dq, D
    torch.cuda.empty_cache()
    return out


def _attn_timing(q, k, v, do, o, lse, D, label, checks):
    """The three attention kernels timed at the shape of q (G, L, H, hd,
    bf16, causal), each against its plain version in turns, beside its
    bound (the larger of bytes, FLOPs and exps) and SDPA (a yardstick);
    ``checks``: each output's `compare` stats there. Returns (the timings,
    SDPA forward ms, SDPA backward ms)."""
    import torch.nn.functional as F

    from caduceus_tpu_torch.ops import attention as A

    G, L, H, hd = q.shape
    sc = hd ** -0.5
    work = _attn_work(G, L, H, hd)
    calls = {
        "attn_fwd": (lambda: A.attention_fwd(q, k, v, True, sc),
                     lambda: A.attention_fwd_plain(q, k, v, True, sc)),
        "attn_bwd_dkv": (
            lambda: A.attention_bwd_dkv(q, k, v, o, lse, do, True, sc),
            lambda: A.attention_bwd_plain(q, k, v, o, lse, do, True, sc)),
        "attn_bwd_dq": (
            lambda: A.attention_bwd_dq(q, k, v, o, lse, do, D, True, sc),
            lambda: A.attention_bwd_plain(q, k, v, o, lse, do, True, sc))}
    # SDPA in its own layout (B, H, L, hd), the copies made beforehand
    qs, ks, vs, gy = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    with torch.no_grad():
        F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        sdpa_fwd = _time_cuda(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True), 3)
    qs, ks, vs = (t.requires_grad_(True) for t in (qs, ks, vs))
    y = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    torch.autograd.grad(y, (qs, ks, vs), gy, retain_graph=True)
    sdpa_bwd = _time_cuda(lambda: torch.autograd.grad(
        y, (qs, ks, vs), gy, retain_graph=True), 3)
    del y, qs, ks, vs, gy
    timing = {}
    for name, (kfn, pfn) in calls.items():
        kfn()
        torch.cuda.synchronize()
        t = _timed(kfn, pfn)
        scores, flops, nbytes = work[name]
        t.update(_bound(nbytes, flops))
        t["scores"] = scores
        t["exps"] = scores
        t["exp_ms"] = scores / EXP_PER_S * 1e3
        t["bound_term"] = "bytes" if t["bound_by"] == "bytes" else "flops"
        if t["exp_ms"] > t["bound_ms"]:
            # one exp a score on the MUFU: the larger operations floor
            t.update(bound_ms=t["exp_ms"], bound_by="operations",
                     bound_term="exps")
        t["library_ms"] = sdpa_fwd if name == "attn_fwd" else None
        if name != "attn_fwd":
            t["sdpa_backward_ms"] = sdpa_bwd
            t["plain_is"] = "attention_bwd_plain (dq, dk and dv together)"
        t["check"] = {n: checks[n] for n in (
            ("o", "lse") if name == "attn_fwd" else
            ("dk", "dv") if name == "attn_bwd_dkv" else ("dq",))}
        t["max_abs_err"] = max(c["max_abs_err"] for c in t["check"].values())
        timing[name] = t
        log(f"[attn_kernels] {name} {label}: {t['ms']:.3f} ms (runs "
            f"{', '.join(f'{x:.3f}' for x in t['kernel_ms_runs'])}), bound "
            f"{t['bound_ms']:.3f} ms (by {t['bound_term']}: {flops / 1e12:.2f} "
            f"TFLOP, {nbytes / 1e9:.3f} GB, exps {scores:.3e} = "
            f"{t['exp_ms']:.3f} ms at 16 a clock per SM); plain "
            f"{t['plain_ms']:.1f} ms; SDPA "
            + (f"forward {sdpa_fwd:.3f} ms" if name == "attn_fwd" else
               f"backward {sdpa_bwd:.3f} ms (dq, dk, dv together)"))
    return timing, sdpa_fwd, sdpa_bwd


def _attn_counts():
    from caduceus_tpu_torch.ops import attention as A

    return {"attn_fwd": A.fwd_launches, "attn_bwd_dkv": A.bwd_dkv_launches,
            "attn_bwd_dq": A.bwd_dq_launches}


def _attn_zero():
    from caduceus_tpu_torch.ops import attention as A

    A.fwd_launches = A.bwd_dkv_launches = A.bwd_dq_launches = 0


def phase_hyena_vs_cpu():
    """[hyena_vs_cpu] the hybrid Hyena LM at full width (d_model 256, 8
    heads of 32), 2 layers (MHA at layer 1), fp32, L=2048, 2 sequences:
    logits and every parameter gradient on the card (the attention kernels,
    cuFFT) against the same model on the CPU (the plain attention, the
    CPU's FFT), from the same weights and batch."""
    from caduceus_tpu_torch.models.hyena import HyenaLMHeadModel

    kw = dict(d_model=256, n_layer=2, vocab_size=12, l_max=2048,
              attn_layer_idx=(1,), num_heads=8)
    ids = torch.from_numpy(np.random.default_rng(8).integers(
        0, 12, (2, 2048)))
    cot = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 2048, 12)).astype(np.float32))
    res = {}
    for dev in ("cpu", "cuda"):
        model = HyenaLMHeadModel(device=dev,
                                 generator=torch.Generator().manual_seed(3),
                                 **kw)
        _attn_zero()
        logits = model(ids.to(dev))
        logits.backward(cot.to(dev))
        res[dev] = (logits.detach().cpu(),
                    {n: p.grad.cpu() for n, p in model.named_parameters()})
        if dev == "cuda":
            counts = _attn_counts()
    check(counts == {"attn_fwd": 1, "attn_bwd_dkv": 1, "attn_bwd_dq": 1},
          f"[hyena_vs_cpu] attention launches {counts}")
    (lc, gc_), (lg, gg) = res["cpu"], res["cuda"]
    err = ((lg - lc).norm() / lc.norm()).item()
    check(err <= MODEL_TOL, f"[hyena_vs_cpu] logits {err:.2e} > {MODEL_TOL}")
    worst = max(((gg[n] - g).abs().max() / g.abs().max().clamp(min=1e-30))
                .item() for n, g in gc_.items())
    check(worst <= TRAIN_TOL["grad"],
          f"[hyena_vs_cpu] a gradient is {worst:.2e} of its max off")
    log(f"[hyena_vs_cpu] 2-layer hybrid, d_model 256, L=2048, fp32: logits "
        f"{err:.2e} (normalized), worst gradient {worst:.2e} of its max; "
        f"attention launches {counts}")
    return {"logits_rel_l2": err, "worst_grad": worst, "launches": counts}


def _hyena_argv(fasta, bed, run_dir, steps=HY_STEPS):
    return ["pretrain", "--model", "hyena", "--ntp", "--fasta", fasta,
            "--bed", bed, "--run-dir", run_dir, "--d-model", "256",
            "--n-layer", str(HY_LAYERS), "--dtype", "bfloat16",
            "--attn-layer-idx", ",".join(map(str, HY_ATTN)),
            "--num-heads", "8", "--hyena-checkpoint", "--lr", "6e-4",
            "--weight-decay", "0.1", "--max-length", str(HY_L),
            "--batch-size", str(HY_BATCH), "--accum-steps", str(HY_ACCUM),
            "--max-steps", str(steps), "--checkpoint-every", "2",
            "--log-every", "1", "--eval-every", "1000"]


def phase_hyena_pretrain(workdir, fasta, bed):
    """[hyena_pretrain] `cli.py pretrain --model hyena --ntp` at
    configs/hg38_hyena.yaml's width (d_model 256, 8 layers, MHA at layers
    1 and 5 with 8 heads, bf16, lr 6e-4, wd 0.1), L = l_max = 65,536, 4
    sequences in 2 micro-batches, 3 steps, ``--hyena-checkpoint``,
    embedding dropout on: run A in this process (the attention kernels'
    launches counted: per micro-batch and MHA layer two forwards, the
    recompute's and the first, and one of each adjoint kernel); run B in
    a subprocess SIGKILLed after its step-2 checkpoint and resumed: B's
    steps equal A's and the final parameters too, bit for bit; then
    `cli.py eval` of run A. Reports the step time, tokens/s and peak
    memory."""
    from caduceus_tpu_torch import cli
    from caduceus_tpu_torch.train import checkpoint

    run_a = os.path.join(workdir, "hyena_a")
    run_b = os.path.join(workdir, "hyena_b")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _attn_zero()
    t0 = time.perf_counter()
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        cli.main(_hyena_argv(fasta, bed, run_a))
    a_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = _attn_counts()
    mb = HY_STEPS * HY_ACCUM
    want = {"attn_fwd": 2 * mb * len(HY_ATTN),
            "attn_bwd_dkv": mb * len(HY_ATTN),
            "attn_bwd_dq": mb * len(HY_ATTN)}
    check(counts == want, f"[hyena_pretrain] launches {counts} != {want}")
    gc.collect()
    torch.cuda.empty_cache()
    log_b = os.path.join(workdir, "hyena_b.log")
    argv_b = _hyena_argv(fasta, bed, run_b)
    ck_b = os.path.join(run_b, "checkpoints")
    t0 = time.perf_counter()
    rc = _run_cli(argv_b, log_b,
                  kill_when=os.path.join(ck_b, "2", "meta.json"))
    b1_s = time.perf_counter() - t0
    check(rc == -9, f"hyena run B was not killed (exit {rc}):\n"
          f"{_tail(log_b)}")
    check(checkpoint.latest_step(ck_b) == 2,
          f"hyena run B killed at step {checkpoint.latest_step(ck_b)}")
    t0 = time.perf_counter()
    rc = _run_cli(argv_b + ["--resume"], log_b)
    b2_s = time.perf_counter() - t0
    check(rc == 0, f"resumed hyena run B failed ({rc}):\n{_tail(log_b)}")
    steps_a, _ = _records(run_a)
    steps_b, _ = _records(run_b)
    check(sorted(steps_a) == sorted(steps_b) == list(range(1, HY_STEPS + 1)),
          f"hyena logged steps A {sorted(steps_a)}, B {sorted(steps_b)}")
    for s in steps_a:
        for key in ("loss", "acc", "grad_norm", "lr"):
            check(steps_a[s][key] == steps_b[s][key],
                  f"hyena step {s} {key}: A {steps_a[s][key]!r} != B "
                  f"{steps_b[s][key]!r}")
        check(math.isfinite(steps_a[s]["loss"]), f"hyena step {s}: loss")
    last = str(HY_STEPS)
    za = np.load(os.path.join(run_a, "checkpoints", last, "params.npz"))
    zb = np.load(os.path.join(run_b, "checkpoints", last, "params.npz"))
    for key in za.files:
        check(np.array_equal(za[key], zb[key]), f"hyena {key}: A != B")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(["eval", "--fasta", fasta, "--bed", bed, "--run-dir", run_a,
                  "--max-length", str(HY_L), "--batch-size", "2",
                  "--max-batches", "1"])
    eval_s = time.perf_counter() - t0
    ev = json.loads(buf.getvalue().strip().splitlines()[-1])
    check(math.isfinite(ev["test/loss"]), f"hyena eval {ev}")
    tokens = HY_BATCH * HY_L
    step_s = {s: tokens / r["tokens_per_sec"] for s, r in steps_a.items()}
    loop_s = float(np.mean([step_s[s] for s in step_s if s > 1]))
    per_step = {k2: v // HY_STEPS for k2, v in counts.items()}
    log(f"[hyena_pretrain] {HY_LAYERS} layers, d_model 256, MHA at "
        f"{HY_ATTN}, L={HY_L}, {HY_BATCH} sequences in {HY_ACCUM} "
        f"micro-batches, bf16, --hyena-checkpoint: run A {a_s:.1f} s for "
        f"{HY_STEPS} steps, seconds per step "
        f"{', '.join(f'{step_s[s]:.3f}' for s in sorted(step_s))} (steps "
        f"2+: {loop_s:.3f} s, {tokens / loop_s:,.0f} tokens/s), peak "
        f"{peak:.2f} GiB; launches per step {per_step}; run B killed after "
        f"its step-2 checkpoint ({b1_s:.1f} s) and resumed ({b2_s:.1f} s): "
        f"its steps and final parameters equal A's bit for bit; eval "
        f"{eval_s:.1f} s: {ev}")
    return {"run_a": run_a, "step_s": step_s, "loop_step_s": loop_s,
            "tokens_per_s": tokens / loop_s, "peak_gib": peak,
            "launches": counts, "launches_per_step": per_step,
            "run_a_s": a_s, "run_b_killed_s": b1_s, "run_b_resumed_s": b2_s,
            "eval": ev, "eval_s": eval_s,
            "steps": {s: {k2: r[k2] for k2 in ("loss", "acc", "grad_norm",
                                                "lr")}
                      for s, r in steps_a.items()}}


def _classify_export(save_dir):
    """/classify of a fine-tuned export over HTTP: 8 sequences equal a
    direct forward of the exported classifier bit for bit; the latency of
    one sequence (median of 5)."""
    from caduceus_tpu_torch.finetune import _make_classifier
    from caduceus_tpu_torch.params import from_jax_params, load_npz_params
    from caduceus_tpu_torch.serve import InferenceServer, InferenceService

    svc = InferenceService.from_run_dir(save_dir, device="cuda", max_batch=8)
    svc.warmup()
    server = InferenceServer(svc, port=0).start()
    rng = np.random.default_rng(13)
    seqs = ["".join(rng.choice(list("ACGT"), int(n)))
            for n in rng.integers(200, 260, 8)]
    try:
        served = _post(server.port, "/classify", {"sequences": seqs})
        one = []
        for i in range(5):
            t0 = time.perf_counter()
            _post(server.port, "/classify", {"sequences": [seqs[i]]})
            one.append(time.perf_counter() - t0)
    finally:
        server.stop()
    tc = svc.task_cfg
    model = _make_classifier(svc.cfg, tc["num_classes"], tc["pooling"],
                             tc["use_lengths"], tc["padding_side"],
                             model_kind=tc["model_kind"], device="cuda",
                             seq_len=tc["max_length"])
    model.load_state_dict(from_jax_params(load_npz_params(
        os.path.join(save_dir, "params.npz")), None, model=model))
    model.eval()
    ids = np.stack([svc.tok.encode_padded(s, tc["max_length"],
                                          add_sep=tc["add_eos"])
                    for s in seqs]).astype(np.int64)
    lengths = torch.tensor([min(len(s), tc["max_length"]) for s in seqs])
    with torch.inference_mode():
        scores = model(torch.from_numpy(ids).cuda(),
                       lengths.cuda()).cpu().numpy()
    for r, sc in zip(served["classify"], scores):
        e = np.exp(sc - sc.max())
        check(r["probs"] == (e / e.sum()).tolist()
              and r["label"] == int(np.argmax(sc)),
              f"/classify {r} != direct forward {sc}")
    del model, svc
    torch.cuda.empty_cache()
    return {"model_kind": tc["model_kind"],
            "latency_1_s": float(np.median(one)), "latency_1_runs": one}


def phase_hyena_finetune(work, data_dir, run_a):
    """[hyena_finetune] `cli.py finetune` with the human_nontata_promoters
    preset (L=251, batch 128) from the Hyena run A (the family taken from
    its model_config.json; 1 epoch, seed 1; the MHA kernels launched) and
    ``--model cnn`` from scratch (1 epoch), each exported and served:
    /classify of both exports equals a direct forward bit for bit."""
    from caduceus_tpu_torch import cli

    out = {}
    for kind, extra in (("hyena", ["--pretrained-run-dir", run_a]),
                        ("cnn", ["--model", "cnn"])):
        save = os.path.join(work, f"finetuned_{kind}")
        argv = ["finetune", "--preset", FT_PRESET, "--data-dir", data_dir,
                "--epochs", "1", "--seeds", "1", "--save-dir", save, *extra]
        _attn_zero()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
        cli_s = time.perf_counter() - t0
        counts = _attn_counts()
        lines = [json.loads(x) for x in buf.getvalue().splitlines()
                 if x.startswith("{")]
        epochs = [r for r in lines if "epoch" in r]
        check(len(epochs) == 1 and all(math.isfinite(r["loss"])
                                       for r in epochs),
              f"[hyena_finetune] {kind}: {epochs}")
        if kind == "hyena":
            check(counts["attn_fwd"] > 0 and counts["attn_bwd_dkv"] > 0
                  and counts["attn_bwd_dq"] > 0,
                  f"[hyena_finetune] attention launches {counts}")
        cls = _classify_export(save)
        out[kind] = {"cli_s": cli_s, "launches": counts,
                     "epochs": epochs, "summary": lines[-1],
                     "classify": cls}
        log(f"[hyena_finetune] {kind}: cli.py finetune ({FT_TASK} preset, "
            f"1 epoch) {cli_s:.1f} s, attention launches {counts}, "
            f"{epochs[0]}; /classify of the export equals a direct forward "
            f"bit for bit, one sequence {cls['latency_1_s'] * 1e3:.1f} ms")
    return out


def _hyena_phases(report, work, fasta, bed):
    """The Hyena phases (the kernels are built)."""
    from caduceus_tpu_torch.data.synthetic import (
        make_structured_classification_suite)

    t0 = time.perf_counter()
    report["attn_kernels"] = phase_attn_kernels()
    report["hyena_vs_cpu"] = phase_hyena_vs_cpu()
    report["hyena_pretrain"] = phase_hyena_pretrain(work, fasta, bed)
    data_dir = os.path.join(work, "tasks")
    if not os.path.isdir(data_dir):
        make_structured_classification_suite(
            data_dir, fasta, tasks={FT_TASK: (2, FT_L)}, n_train=FT_TRAIN,
            n_test=FT_TEST)
    report["hyena_finetune"] = phase_hyena_finetune(
        work, data_dir, report["hyena_pretrain"].pop("run_a"))
    report["hyena_phase_s"] = time.perf_counter() - t0


def _hyena_kernel_entries(report, entry):
    """The kernels line's rows of the three attention kernels: timed at the
    path shape, launched in `cli.py pretrain --model hyena`."""
    at = report["attn_kernels"]["timing"]
    hp = report["hyena_pretrain"]
    rows = []
    for name, src in (("attn_fwd", "attention_fwd.cu"),
                      ("attn_bwd_dkv", "attention_bwd.cu"),
                      ("attn_bwd_dq", "attention_bwd.cu")):
        t = at[name]
        extra = {k: t[k] for k in ("exps", "exp_ms", "bound_term",
                                   "sdpa_backward_ms", "plain_is") if k in t}
        row = entry(name, f"caduceus_tpu_torch/csrc/{src}", t,
                    hp["launches"][name], t["max_abs_err"],
                    shape=f"G={ATTN_G} L={ATTN_L} H={ATTN_H} hd={ATTN_HD} "
                    "bf16 causal",
                    launches_path=f"cli.py pretrain --model hyena, "
                    f"{HY_LAYERS} layers, MHA at {list(HY_ATTN)}, "
                    f"L={HY_L}, {HY_STEPS} steps of {HY_ACCUM} "
                    "micro-batches, --hyena-checkpoint",
                    launches_per_step=hp["launches_per_step"][name],
                    **extra)
        if name == "attn_fwd" and "convert" in report:
            row["launches_convert"] = report["convert"]["hyena"]["launches"]
        if "polls" in report["attn_kernels"]:
            row["max_polls_of_a_wait"] = \
                report["attn_kernels"]["polls"][name]["max"]
        row["library_ms"] = t["library_ms"]
        rows.append(row)
    return rows


def _imports_here(*names):
    out = {}
    for n in names:
        try:
            __import__(n)
            out[n] = True
        except ImportError:
            out[n] = False
    return out


def _cp_phases(report, work, fasta, bed):
    """The context- and data-parallel phases (the kernels are built)."""
    t0 = time.perf_counter()
    report["cp_kernels"] = phase_cp_kernels()
    report["cp_train"] = phase_cp_train(work, fasta, bed)
    report["dp_train"] = phase_dp_train(work, fasta, bed)
    report["cp_phase_s"] = time.perf_counter() - t0


def _cp_kernel_entries(report, entry):
    """The kernels line's rows of the CP entry: #1 / #3a / #3b with
    edge_hist at the CP shape, launches per rank of `cli.py pretrain` v2
    (`CP_V2_LAYERS` layers, 2 steps) under context parallelism."""
    ct = report["cp_kernels"]["timing"]
    counts = report["cp_train"]["cli_v2"]["launches_per_rank"]
    shape = (f"G={CP_G} L={CP_L_LOC} bf16 with edge_hist (one rank's shard "
             f"of a {CP_L}-row sequence)")
    path = (f"cli.py pretrain v2 {CP_V2_LAYERS} layers, L=262144, "
            "--mesh-model 2 --context-parallel, 2 steps, per rank")
    rows = []
    for name, kname, src in (
            ("ssd_fused_cp", "ssd_fused_fwd", "ssd_fused_fwd.cu"),
            ("ssd_fused_bwd_kernel_cp", "ssd_fused_bwd_kernel",
             "ssd_fused_bwd.cu"),
            ("ssd_conv_bwd_kernel_cp", "ssd_conv_bwd_kernel",
             "ssd_fused_bwd.cu")):
        t = ct[kname]
        rows.append(entry(name, f"caduceus_tpu_torch/csrc/{src}", t,
                          counts[name], t["check"]["max_abs_err"],
                          shape=shape, launches_path=path,
                          without_edge_ms=t["without_edge_ms"]))
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on a CUDA card", file=sys.stderr)
        return 1
    import caduceus_tpu_torch  # noqa: F401  (fails outside a checkout)

    if len(sys.argv) > 2 and sys.argv[1] == "--rank-job":
        return rank_job(sys.argv[2])
    only = sys.argv[2] if sys.argv[1:2] == ["--only"] else None
    if (only not in (None, "cp", "hyena", "convert", "tp", "serve", "svm")
            or len(sys.argv) > 3):
        print("usage: chip_smoke.py [--only cp|hyena|convert|tp|serve|svm]",
              file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}; nvidia-smi: {card}")
    if only == "svm":      # runs no kernel: no build
        log("[report] " + json.dumps({"svm": phase_svm()}))
        return 0
    report = {"build": phase_build()}
    phases = time.perf_counter()
    if only in ("convert", "serve"):
        report[only] = {"convert": phase_convert,
                        "serve": phase_serve}[only]()
        log("[report] " + json.dumps(report))
        return 0
    if only is not None:
        # the parallel, the Hyena or the tensor-parallel phases alone, for
        # work on them
        from caduceus_tpu_torch.data.synthetic import make_synthetic_genome

        with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{only}_") as work:
            fasta, bed = make_synthetic_genome(
                os.path.join(work, "genome"), n_chromosomes=GENOME_CONTIGS,
                chrom_len=GENOME_CONTIG_LEN, window=GENOME_WINDOW)
            {"cp": _cp_phases, "hyena": _hyena_phases,
             "tp": _tp_phases}[only](report, work, fasta, bed)
        log("[report] " + json.dumps(report))
        return 0
    report["ssd_checks"], report["planted_faults"] = phase_kernel_checks()
    report["bwd_checks"], report["bwd_planted_faults"] = phase_bwd_checks()
    report["conv_checks"], report["conv_planted_faults"] = phase_conv_checks()
    report["model_vs_cpu"] = phase_model_vs_cpu()
    report["serve"] = phase_serve()
    report["train_vs_cpu"] = phase_train_vs_cpu()
    # 8 of the 16 layers: the 16-layer step was measured in earlier runs
    # (PERF.md), and the generation phases need the time
    report["train"] = phase_train_full(n_layer=8)
    report["timing"] = phase_timing()
    report["determinism"] = phase_determinism()
    t_gen = time.perf_counter()
    (report["unfused_checks"],
     report["unfused_planted_faults"]) = phase_unfused_checks()
    report["v2_prefill_vs_cpu"] = phase_prefill_vs_cpu(2)
    report["v2_generate"] = phase_generate_serve(2)
    report["unfused_timing"] = phase_unfused_timing()
    report["v2_generate_phase_s"] = time.perf_counter() - t_gen
    t_v1 = time.perf_counter()
    report["scan_checks"], report["scan_planted_faults"] = phase_scan_checks()
    (report["scan_bwd_checks"],
     report["scan_bwd_planted_faults"]) = phase_scan_bwd_checks()
    report["v1_model_vs_cpu"] = phase_model_vs_cpu(hg38_mlm_config)
    report["v1_serve"] = phase_v1_serve()
    report["convert"] = phase_convert()
    # one v1 layer: the CPU's plain scans take ~25 s a layer on an 8-core
    # host, and this step runs twice (also with CADUCEUS_BIDIR_BWD=1)
    report["v1_train_vs_cpu"] = phase_train_vs_cpu(hg38_mlm_config, 1)
    report["mamba_mixer_step"] = phase_mamba_mixer_step()
    report["v1_train"] = phase_train_full(hg38_mlm_config)
    report["scan_timing"] = phase_scan_timing()
    t_gen = time.perf_counter()
    report["v1_prefill_vs_cpu"] = phase_prefill_vs_cpu(1)
    report["v1_generate"] = phase_generate_serve(1)
    report["v1_generate_phase_s"] = time.perf_counter() - t_gen
    report["v1_phase_s"] = time.perf_counter() - t_v1
    # the unfused SSD adjoint and the per-head v2 route (#4, #5, #6)
    t_new = time.perf_counter()
    (report["unfused_bwd_checks"],
     report["unfused_bwd_planted_faults"]) = phase_unfused_bwd_checks()
    report["chained_grad"] = phase_chained_grad()
    report["head_model_vs_cpu"] = phase_model_vs_cpu(
        hg38_mlm_v2_pallas_config)
    report["head_train_vs_cpu"] = phase_train_vs_cpu(
        hg38_mlm_v2_pallas_config)
    report["head_train"] = phase_train_full(hg38_mlm_v2_pallas_config,
                                            n_layer=8)
    report["head_serve"] = phase_head_serve()
    report["head_prefill_vs_cpu"] = phase_prefill_vs_cpu(2, "pallas")
    # the paired v1 backward (#10)
    (report["bidir_bwd_checks"],
     report["bidir_bwd_planted_faults"]) = phase_bidir_bwd_checks()
    with mock.patch.dict(os.environ, {"CADUCEUS_BIDIR_BWD": "1"}):
        log("[train] v1 with the paired backward (CADUCEUS_BIDIR_BWD=1):")
        report["paired_train_vs_cpu"] = phase_train_vs_cpu(hg38_mlm_config,
                                                           1)
        report["paired_train"] = phase_train_full(hg38_mlm_config)
    report["new_timing"] = phase_new_timing()
    report["new_phase_s"] = time.perf_counter() - t_new
    # pretraining through the port's own loop: data, Trainer, checkpoints,
    # the CLI, kill and resume
    t_pre = time.perf_counter()
    from caduceus_tpu_torch.data.synthetic import make_synthetic_genome

    with tempfile.TemporaryDirectory(prefix="chip_smoke_pretrain_") as work:
        fasta, bed = make_synthetic_genome(
            os.path.join(work, "genome"), n_chromosomes=GENOME_CONTIGS,
            chrom_len=GENOME_CONTIG_LEN, window=GENOME_WINDOW)
        report["imports"] = _imports_here("tensorstore", "yaml")
        log(f"[pretrain] importable on this machine: {report['imports']}")
        report["loader"] = phase_loader_timing(fasta, bed)
        # the bare make_train_step at the loop's geometry is [train]'s
        report["pretrain_bare"] = report["train"]
        report["pretrain"] = phase_pretrain(work, fasta, bed,
                                            hg38_mlm_v2_config,
                                            PRETRAIN_LAYERS)
        run_a = report["pretrain"].pop("run_a")
        report["pretrain_reads"] = phase_pretrain_reads(run_a, fasta, bed)
        report["v1_pretrain"] = phase_pretrain(work, fasta, bed,
                                               hg38_mlm_config, 4)
        v1_run_a = report["v1_pretrain"].pop("run_a")
        report["pretrain_phase_s"] = time.perf_counter() - t_pre
        # downstream of run A: fine-tuning, /classify, VEP
        t_down = time.perf_counter()
        from caduceus_tpu_torch.data.synthetic import (
            make_structured_classification_suite)

        report["finetune_kernels"] = phase_finetune_kernels()
        data_dir = make_structured_classification_suite(
            os.path.join(work, "tasks"), fasta, tasks={FT_TASK: (2, FT_L)},
            n_train=FT_TRAIN, n_test=FT_TEST)
        save = os.path.join(work, "finetuned")
        report["finetune"] = phase_finetune(data_dir, run_a, "hg38_mlm_v2",
                                            PRETRAIN_LAYERS, 2, (1, 2),
                                            save_dir=save)
        report["v1_finetune"] = phase_finetune(data_dir, v1_run_a, "hg38_mlm",
                                               4, 1, (1,), full=False)
        report["classify"] = phase_classify(save)
        report["vep"] = phase_vep(work, fasta, run_a, "hg38_mlm_v2")
        report["v1_vep"] = phase_vep(work, fasta, v1_run_a, "hg38_mlm")
        report["svm"] = phase_svm()
        report["downstream_phase_s"] = time.perf_counter() - t_down
        # the Hyena family: the attention kernels, pretrain, fine-tune
        _hyena_phases(report, work, fasta, bed)
        # data and context parallelism: two ranks on this card
        _cp_phases(report, work, fasta, bed)
        # tensor parallelism (and CP x TP, VEP over two processes): two
        # and four ranks on this card
        _tp_phases(report, work, fasta, bed, vep_run=run_a)
    pre, bare = report["pretrain"], report["pretrain_bare"]
    pre["overhead"] = pre["loop_step_s"] / bare["step_s"] - 1
    log(f"[pretrain] loop step {pre['loop_step_s']:.3f} s against the bare "
        f"step {bare['step_s']:.3f} s at {PRETRAIN_LAYERS} layers: "
        f"{pre['overhead']:+.1%}")
    report["phase_s"] = time.perf_counter() - phases
    tm, tr = report["timing"], report["train"]
    # share of the training step inside the kernels (derived: per-launch
    # times at the same shape x launches per step)
    per_step = {k: v // tr["micro_batches"] * tr["accum"] for k, v in
                tr["launches"].items()}
    ms = {"ssd_fused_fwd": tm["fwd_G4_carries"]["ms"],
          "ssd_fused_bwd_kernel": tm["bwd_main"]["ms"],
          "ssd_conv_bwd_kernel": tm["bwd_conv"]["ms"]}
    tr["kernel_s_per_step"] = {k: per_step[k] * ms[k] / 1e3 for k in ms}
    tr["kernel_share"] = sum(tr["kernel_s_per_step"].values()) / tr["step_s"]
    log(f"[train] derived: kernels take {tr['kernel_share']:.1%} of the step "
        f"({', '.join(f'{k} {v:.2f} s' for k, v in tr['kernel_s_per_step'].items())})")

    st, t1 = report["scan_timing"], report["v1_train"]
    v1_ms = {"bidir_scan_fwd": st["bidir"]["ms"],
             "selective_scan_bwd": st["bwd"]["ms"]}
    t1["kernel_s_per_step"] = {
        k: t1["launches"][k] // t1["micro_batches"] * t1["accum"] * v / 1e3
        for k, v in v1_ms.items()}
    t1["kernel_share"] = sum(t1["kernel_s_per_step"].values()) / t1["step_s"]
    shares = ", ".join(f"{k} {v:.2f} s"
                       for k, v in t1["kernel_s_per_step"].items())
    log(f"[train] derived, v1: kernels take {t1['kernel_share']:.1%} of the "
        f"step ({shares})")
    nt, ht = report["new_timing"], report["head_train"]
    head_ms = {"ssd_head_fwd": nt["head_fwd"]["ms"],
               "ssd_head_bwd": nt["head_bwd"]["ms"]}
    ht["kernel_s_per_step"] = {
        k: ht["launches"][k] // ht["micro_batches"] * ht["accum"] * v / 1e3
        for k, v in head_ms.items()}
    ht["kernel_share"] = sum(ht["kernel_s_per_step"].values()) / ht["step_s"]
    shares = ", ".join(f"{k} {v:.2f} s"
                       for k, v in ht["kernel_s_per_step"].items())
    log(f"[train] derived, per-head v2: kernels take {ht['kernel_share']:.1%} "
        f"of the step ({shares})")

    replaces = {
        "ssd_fused_fwd": "caduceus_tpu/ops/ssd_pallas_batched.py:173",
        "ssd_fwd": "caduceus_tpu/ops/ssd_pallas_batched.py:173",
        "ssd_fused_bwd_kernel": "caduceus_tpu/ops/ssd_pallas_batched.py:486",
        "ssd_conv_bwd_kernel": "caduceus_tpu/ops/ssd_pallas_batched.py:486",
        "ssd_head_fwd": "caduceus_tpu/ops/ssd_pallas.py:114",
        "ssd_head_bwd": "caduceus_tpu/ops/ssd_pallas.py:312",
        "ssd_bwd": "caduceus_tpu/ops/ssd_pallas_batched.py:486",
        "selective_scan_fwd": "caduceus_tpu/ops/scan_pallas.py:153",
        "bidir_scan_fwd": "caduceus_tpu/ops/scan_pallas_bidir.py:37",
        "selective_scan_bwd": "caduceus_tpu/ops/scan_pallas.py:462",
        "bidir_scan_bwd": "caduceus_tpu/ops/scan_pallas_bidir.py:210",
        "ssd_fused_cp": "caduceus_tpu/ops/ssd_pallas_batched.py:1214",
        "ssd_fused_bwd_kernel_cp": "caduceus_tpu/ops/ssd_pallas_batched.py:1256",
        "ssd_conv_bwd_kernel_cp": "caduceus_tpu/ops/ssd_pallas_batched.py:1256",
        # the Pallas TPU flash attention that ships with JAX, called from
        # caduceus_tpu/ops/attention.py:70-77
        "attn_fwd": "jax/experimental/pallas/ops/tpu/flash_attention.py:758",
        "attn_bwd_dkv":
            "jax/experimental/pallas/ops/tpu/flash_attention.py:1121",
        "attn_bwd_dq":
            "jax/experimental/pallas/ops/tpu/flash_attention.py:1456"}

    def entry(name, source, t, launches, err, **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces[name],
                "launches": launches, "max_abs_err": err, "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": None,
                "check": "pass", **extra}

    f16 = tm["fwd_G16"]
    ut = report["unfused_timing"]
    ftt = report["finetune_kernels"]["timing"]
    ft_launch = {k: report["finetune"]["launches"][k]
                 + report["v1_finetune"]["launches"][k]
                 for k in report["finetune"]["launches"]}

    def ft(name):
        """The kernel at the fine-tuning shape and its launches there."""
        t = ftt[name]
        return {"finetune_G256_L251": {k: t[k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by")},
                "launches_finetune": ft_launch[name]}

    # the backward's two kernels split its bound; the workspace traffic of
    # the split stands beside it
    pair = {"function_bound_ms": tm["bwd_function_bound"]["bound_ms"]}
    kernels = {"kernels": [
        entry("ssd_fused_fwd", "caduceus_tpu_torch/csrc/ssd_fused_fwd.cu",
              tm["fwd_G4_carries"], tr["launches"]["ssd_fused_fwd"],
              tm["fwd_G4_carries"]["check"]["y"]["max_abs_err"],
              shape="G=4 L=131072 bf16, carries saved",
              segments=tm["fwd_G4_carries"]["segments"],
              sub_launches=tm["fwd_G4_carries"]["sub_launches"],
              launches_serve=report["serve"]["launches"],
              launches_pretrain=pre["launches"]["ssd_fused_fwd"],
              serve_G16={k: f16[k] for k in ("ms", "plain_ms", "bound_ms",
                                             "bound_by")},
              launches_vep=report["vep"]["launches"]["ssd_fused_fwd"],
              launches_convert=report["convert"]["rc"]["v2_bf16_L131072"][
                  "ssd_fused_fwd_launches"],
              **ft("ssd_fused_fwd")),
        entry("ssd_fwd", "caduceus_tpu_torch/csrc/ssd_fused_fwd.cu", ut["G1"],
              report["v2_generate"]["launches"],
              ut["G1"]["check"]["y"]["max_abs_err"],
              shape="G=1 L=131072 bf16 (one 131k prefill), no carries",
              launches_path="/generate of the v2 causal model: prompts of "
              "1,000 and 131,072 tokens, 16 layers each",
              G4={k: ut["G4"][k] for k in ("ms", "plain_ms", "bound_ms",
                                            "bound_by")},
              G1_fp32={k: ut["G1_fp32"][k] for k in ("ms", "plain_ms",
                                                      "bound_ms", "bound_by")}),
        entry("ssd_fused_bwd_kernel", "caduceus_tpu_torch/csrc/ssd_fused_bwd.cu",
              tm["bwd_main"], tr["launches"]["ssd_fused_bwd_kernel"],
              tm["bwd_main"]["check"]["g_xc"]["max_abs_err"],
              shape="G=4 L=131072 bf16",
              segments=tm["bwd_main"]["segments"],
              sub_launches=tm["bwd_main"]["sub_launches"],
              extra_bytes=tm["bwd_main"]["extra_bytes"],
              launches_pretrain=pre["launches"]["ssd_fused_bwd_kernel"],
              **ft("ssd_fused_bwd_kernel"), **pair),
        entry("ssd_conv_bwd_kernel", "caduceus_tpu_torch/csrc/ssd_fused_bwd.cu",
              tm["bwd_conv"], tr["launches"]["ssd_conv_bwd_kernel"],
              tm["bwd_conv"]["check"]["g_xBC"]["max_abs_err"],
              shape="G=4 L=131072 bf16",
              extra_bytes=tm["bwd_conv"]["extra_bytes"],
              floor_ms=tm["bwd_conv"]["floor"]["bound_ms"],
              library_pair_ms=tm["bwd_conv"]["library_pair"]["ms"],
              library_pair="2 calls: torch.ops.aten.silu_backward + "
              "convolution_backward (depthwise, fp32, pre and padded xBC "
              "made beforehand)",
              launches_pretrain=pre["launches"]["ssd_conv_bwd_kernel"],
              **ft("ssd_conv_bwd_kernel"), **pair),
        entry("selective_scan_fwd",
              "caduceus_tpu_torch/csrc/selective_scan_fwd.cu", st["fwd"],
              report["mamba_mixer_step"]["launches"]["selective_scan_fwd"],
              st["fwd"]["check"]["y"]["max_abs_err"],
              shape="G=4 L=131072 bf16, one direction, carries saved",
              launches_path="MambaMixer train step (2 layers, accum 2)",
              launches_generate=report["v1_generate"]["launches"],
              launches_convert=report["convert"]["mamba"]["launches"],
              exps=st["fwd"]["exps"], exp_ms=st["fwd"]["exp_ms"],
              exps_softplus=st["fwd"]["exps_softplus"],
              G1_fp32={k: st["fwd_G1_fp32"][k] for k in (
                  "ms", "plain_ms", "bound_ms", "bound_by", "exps", "exp_ms")},
              G1_bf16={k: st["fwd_G1_bf16"][k] for k in (
                  "ms", "plain_ms", "bound_ms", "bound_by", "exps", "exp_ms")},
              gated={k: st["fwd_gated"][k] for k in (
                  "ms", "plain_ms", "bound_ms", "bound_by", "exps", "exp_ms")}),
        entry("bidir_scan_fwd",
              "caduceus_tpu_torch/csrc/selective_scan_fwd.cu", st["bidir"],
              t1["launches"]["bidir_scan_fwd"],
              st["bidir"]["check"]["yf"]["max_abs_err"],
              shape="G=4 L=131072 bf16, two directions, carries saved",
              launches_serve=report["v1_serve"]["launches"],
              launches_pretrain=report["v1_pretrain"]["launches"][
                  "bidir_scan_fwd"],
              launches_vep=report["v1_vep"]["launches"]["bidir_scan_fwd"],
              launches_convert=report["convert"]["v1"]["launches_serve"],
              **ft("bidir_scan_fwd"),
              exps=st["bidir"]["exps"], exp_ms=st["bidir"]["exp_ms"],
              exps_softplus=st["bidir"]["exps_softplus"]),
        entry("selective_scan_bwd",
              "caduceus_tpu_torch/csrc/selective_scan_bwd.cu", st["bwd"],
              t1["launches"]["selective_scan_bwd"],
              st["bwd"]["check"]["g_u"]["max_abs_err"],
              shape="G=4 L=131072 bf16, one direction",
              extra_bytes=st["bwd"]["extra_bytes"],
              launches_pretrain=report["v1_pretrain"]["launches"][
                  "selective_scan_bwd"],
              **ft("selective_scan_bwd"),
              bc_shares=st["bwd"]["bc_shares"],
              sub_launches=st["bwd"]["sub_launches"],
              exps=st["bwd"]["exps"], exp_ms=st["bwd"]["exp_ms"],
              exps_softplus=st["bwd"]["exps_softplus"]),
        entry("ssd_head_fwd", "caduceus_tpu_torch/csrc/ssd_fused_fwd.cu",
              nt["head_fwd"], ht["launches"]["ssd_head_fwd"],
              nt["head_fwd"]["check"]["y"]["max_abs_err"],
              shape="G=4 L=131072 bf16, carries saved (the K = 0 kernel of "
              "ssd_fwd, per-head entry ops/ssd_head.py)",
              launches_path="use_kernel=pallas train step, 8 layers",
              launches_serve=report["head_serve"]["launches"]),
        entry("ssd_head_bwd", "caduceus_tpu_torch/csrc/ssd_fused_bwd.cu",
              nt["head_bwd"], ht["launches"]["ssd_head_bwd"],
              nt["head_bwd"]["check"]["g_x"]["max_abs_err"],
              shape="G=4 L=131072 bf16 (the K = 0 kernel of ssd_bwd, "
              "per-head entry ops/ssd_head.py)",
              launches_path="use_kernel=pallas train step, 8 layers"),
        entry("ssd_bwd", "caduceus_tpu_torch/csrc/ssd_fused_bwd.cu",
              nt["unfused_bwd"], report["chained_grad"]["launches"]["ssd_bwd"],
              nt["unfused_bwd"]["check"]["g_x"]["max_abs_err"],
              shape="G=4 L=131072 bf16",
              launches_path="ssd_batched_chained under autograd: two "
              "chained calls and one whole call"),
        entry("bidir_scan_bwd",
              "caduceus_tpu_torch/csrc/selective_scan_bwd.cu", nt["bidir_bwd"],
              report["paired_train"]["launches"]["bidir_scan_bwd"],
              nt["bidir_bwd"]["check"]["g_uf"]["max_abs_err"],
              shape="G=4 L=131072 bf16, two directions",
              launches_path="v1 train step with CADUCEUS_BIDIR_BWD=1, 16 "
              "layers", two_launch_ms=nt["bidir_bwd"]["two_launch_ms"],
              extra_bytes=nt["bidir_bwd"]["extra_bytes"],
              exps=nt["bidir_bwd"]["exps"]),
    ] + _cp_kernel_entries(report, entry)
        + _hyena_kernel_entries(report, entry)}
    extras = _tp_kernel_extras(report)
    for row in kernels["kernels"]:
        row.update(extras.get(row["name"], {}))
    report.update(kernels)
    report["card"] = card
    report["seconds"] = time.perf_counter() - t_start
    log("[report] " + json.dumps(report))
    log(json.dumps(kernels))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
