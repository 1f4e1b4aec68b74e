"""Variant effect prediction (VEP): embeddings around each variant, then an
SVM over them.

Port of `caduceus_tpu/vep.py`:

- `read_variants`, `variant_window` and `extract_embeddings` (`:30-72`),
  owned copies of the numpy parts;
- `dump_embeddings` (`:75-181`): a frozen forward of the reference and the
  alternate window of each variant (``seq_len`` bases centred on it), the
  hidden states mean-pooled over `WINDOW_SIZE_BP` around the variant, ref
  and alt concatenated. An RCPS model's (B, L, 2d) states collapse to the
  strand mean; a non-RCPS model also runs the reverse complements, flips
  their states back along L and averages them with the forward ones.
  Records whose reference base does not match the FASTA are skipped. The
  windows are cut on the device; only they cross to the host;
- `combine_embeddings`, and `svm_eval` (`:202-277`), JAX's protocol line
  for line on `svm.py`'s `StandardScaler` and `SVC` (libsvm's solver in
  float64 torch, on the card by default) and `train/metrics.py roc_auc`:
  no scikit-learn, which the card's machine does not have;
- `main`: ``cli.py vep``, in one process or in several under
  `torch.distributed.run` (``python -m torch.distributed.run --standalone
  --nproc_per_node N -m caduceus_tpu_torch.cli vep ...``): each rank
  takes ``variants[rank::world_size]`` on ``cuda:{LOCAL_RANK %
  device_count}`` (`parallel/mesh.py launch_env`, `launch_device`) and
  writes ``<out>.rank<r>.npz``; the ranks meet at a barrier (a gloo
  process group) before rank 0 combines the shards, which the JAX module
  does without one (it can read a shard another rank has not written
  yet). It prints the peak device memory once, on rank 0 (the JAX module
  prints it on every rank); with ``--svm`` rank 0 alone scores, on its
  device.
"""

from __future__ import annotations

import argparse
import csv
import json
from typing import Dict, List, Tuple

import numpy as np
import torch

from caduceus_tpu_torch import resolve_device

WINDOW_SIZE_BP = 1536
TSS_BUCKETS = ((0, 30_000), (30_000, 100_000), (100_000, 10**12))


def read_variants(path: str) -> List[Dict]:
    """``chrom pos ref alt label [tss_distance]`` rows (0-based pos)."""
    rows = []
    with open(path) as f:
        for rec in csv.reader(f, delimiter="\t"):
            if not rec or rec[0].startswith("#"):
                continue
            rows.append(
                dict(
                    chrom=rec[0],
                    pos=int(rec[1]),
                    ref=rec[2],
                    alt=rec[3],
                    label=int(rec[4]),
                    tss_distance=int(rec[5]) if len(rec) > 5 else 0,
                )
            )
    return rows


def variant_window(fasta, chrom: str, pos: int, seq_len: int
                   ) -> Tuple[str, int]:
    """Sequence of `seq_len` centered on `pos`; returns (seq, variant_idx)."""
    chrom_len = fasta.length(chrom)
    start = pos - seq_len // 2
    end = start + seq_len
    if start < 0:
        start, end = 0, seq_len
    if end > chrom_len:
        start, end = chrom_len - seq_len, chrom_len
    return fasta.fetch(chrom, start, end), pos - start


def _window(idx: int, L: int, window_bp: int) -> Tuple[int, int]:
    half = window_bp // 2
    return max(0, int(idx) - half), min(L, int(idx) + half)


def extract_embeddings(hidden: np.ndarray, variant_idx: np.ndarray,
                       window_bp: int = WINDOW_SIZE_BP) -> np.ndarray:
    """Mean over a `window_bp` window centered on each variant. hidden:
    (B, L, d)."""
    B, L, d = hidden.shape
    out = np.zeros((B, d), hidden.dtype)
    for i in range(B):
        s, e = _window(variant_idx[i], L, window_bp)
        out[i] = hidden[i, s:e].mean(axis=0)
    return out


def dump_embeddings(
    cfg,
    params: Dict[str, torch.Tensor],
    fasta_path: str,
    variants_path: str,
    out_path: str,
    seq_len: int = 131072,
    batch_size: int = 2,
    rank: int = 0,
    world_size: int = 1,
    device="cuda",
) -> str:
    """Frozen forwards → per-variant (ref_emb, alt_emb) concat →
    ``<out_path>.rank<rank>.npz`` (features, labels, tss_distance).

    ``params`` is a state_dict whose ``backbone.*`` keys the backbone takes
    (an MLM's, as `params.py load_run_dir` returns, or `Caduceus`'s)."""
    from caduceus_tpu_torch.data.fasta import FastaFile
    from caduceus_tpu_torch.models.caduceus import (
        Caduceus,
        collapse_strand_mean,
    )
    from caduceus_tpu_torch.tokenization import CaduceusTokenizer

    dev = resolve_device(device)
    tok = CaduceusTokenizer(model_max_length=seq_len)
    complement = torch.from_numpy(
        tok.complement_array(cfg.padded_vocab_size).astype(np.int64)).to(dev)
    fasta = FastaFile(fasta_path)
    variants = read_variants(variants_path)[rank::world_size]

    model = Caduceus(cfg, device=dev)
    model.load_state_dict({k: v for k, v in params.items()
                           if k.startswith("backbone.")})
    model.eval()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    def hidden(ids):
        h = model(ids)
        if cfg.rcps:
            h = collapse_strand_mean(h)
        h = h.float()
        if not cfg.rcps:
            # model(rc(ids)) flipped back along L, so the variant index
            # lines up, then the strand average
            h_rc = model(complement[ids.flip(-1)]).flip(-2).float()
            h = (h + h_rc) / 2
        return h

    feats, labels, tss = [], [], []
    buf_ref, buf_alt, buf_idx, buf_meta = [], [], [], []

    def flush():
        if not buf_ref:
            return
        ids = torch.from_numpy(
            np.stack(buf_ref + buf_alt).astype(np.int64)).to(dev)
        idx = np.asarray(buf_idx + buf_idx)
        with torch.inference_mode():
            h = hidden(ids)
            # only the rows of the windows cross to the host
            L = h.shape[1]
            lo = min(_window(i, L, WINDOW_SIZE_BP)[0] for i in idx)
            hi = max(_window(i, L, WINDOW_SIZE_BP)[1] for i in idx)
            win = h[:, lo:hi].cpu().numpy()
        # within rows [lo, hi) each window clamps to the same bounds as
        # within the full rows
        emb = extract_embeddings(win, idx - lo)
        n = len(buf_ref)
        for i in range(n):
            feats.append(np.concatenate([emb[i], emb[n + i]]))
            labels.append(buf_meta[i][0])
            tss.append(buf_meta[i][1])
        buf_ref.clear()
        buf_alt.clear()
        buf_idx.clear()
        buf_meta.clear()

    for v in variants:
        seq, vidx = variant_window(fasta, v["chrom"], v["pos"], seq_len)
        if seq[vidx].upper() != v["ref"].upper():
            continue  # the reference base does not match: skipped
        alt_seq = seq[:vidx] + v["alt"] + seq[vidx + 1:]
        buf_ref.append(tok.encode(seq))
        buf_alt.append(tok.encode(alt_seq))
        buf_idx.append(vidx)
        buf_meta.append((v["label"], v["tss_distance"]))
        if len(buf_ref) == batch_size:
            flush()
    flush()
    fasta.close()

    if rank == 0 and dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated(dev)
        print(json.dumps({"vep_peak_hbm_gib": round(peak / 2**30, 2),
                          "seq_len": seq_len, "batch_size": batch_size}))

    out_file = f"{out_path}.rank{rank}.npz"
    np.savez(
        out_file,
        features=np.stack(feats) if feats else np.zeros((0, 1)),
        labels=np.asarray(labels, np.int32),
        tss_distance=np.asarray(tss, np.int64),
    )
    return out_file


def combine_embeddings(out_path: str, world_size: int) -> str:
    """Merge the per-rank shards into ``<out_path>.npz``."""
    feats, labels, tss = [], [], []
    for r in range(world_size):
        d = np.load(f"{out_path}.rank{r}.npz")
        if d["features"].size:
            feats.append(d["features"])
            labels.append(d["labels"])
            tss.append(d["tss_distance"])
    np.savez(
        out_path + ".npz",
        features=np.concatenate(feats) if feats else np.zeros((0, 1)),
        labels=np.concatenate(labels) if labels else np.zeros(0, np.int32),
        tss_distance=np.concatenate(tss) if tss else np.zeros(0, np.int64),
    )
    return out_path + ".npz"


def svm_eval(
    embeddings_path: str,
    Cs=(1, 5, 10),
    seeds=(0, 1, 2, 3, 4),
    train_frac: float = 0.8,
    val_frac: float = 0.25,
    device="cuda",
) -> Dict:
    """SVC + AUROC by TSS-distance bucket. Per seed: C chosen on a
    validation split carved out of the train portion (never on test); the
    bucket AUROCs from that C's test scores; ``per_C`` reports every C's
    test AUROC. The scaler and the SVMs run on ``device`` (`svm.py`)."""
    from caduceus_tpu_torch.svm import SVC, StandardScaler
    from caduceus_tpu_torch.train.metrics import roc_auc

    d = np.load(embeddings_path)
    X, y, tss = d["features"], d["labels"], d["tss_distance"]
    results = {"overall": [],
               "buckets": {f"{lo}-{hi}": [] for lo, hi in TSS_BUCKETS}}
    per_C = {C: [] for C in Cs}
    selected_Cs = []
    for seed in seeds:
        rng = np.random.default_rng(seed)
        perm = rng.permutation(len(y))
        n_train = int(len(y) * train_frac)
        tr, te = perm[:n_train], perm[n_train:]
        n_val = max(1, int(len(tr) * val_frac))
        fit, va = tr[:-n_val], tr[-n_val:]
        if (len(np.unique(y[tr])) < 2 or len(np.unique(y[te])) < 2
                or len(np.unique(y[fit])) < 2):
            continue
        best_C, best_val = None, -1.0
        test_scores_by_C = {}
        # the JAX loop fits the same scaler once per C
        scaler = StandardScaler(device).fit(X[fit])
        x_fit, x_te, x_va = (scaler.transform(X[fit]), scaler.transform(
            X[te]), scaler.transform(X[va]))
        for C in Cs:
            clf = SVC(C=C, device=device).fit(x_fit, y[fit])
            test_scores_by_C[C] = clf.decision_function(x_te)
            per_C[C].append(roc_auc(test_scores_by_C[C], y[te]))
            if len(np.unique(y[va])) == 2:
                val_auc = roc_auc(clf.decision_function(x_va), y[va])
                if val_auc > best_val:
                    best_val, best_C = val_auc, C
        if best_C is None:
            best_C = Cs[0]
        selected_Cs.append(int(best_C))
        scores = test_scores_by_C[best_C]
        results["overall"].append(roc_auc(scores, y[te]))
        for lo, hi in TSS_BUCKETS:
            m = (np.abs(tss[te]) >= lo) & (np.abs(tss[te]) < hi)
            if m.sum() > 1 and len(np.unique(y[te][m])) == 2:
                results["buckets"][f"{lo}-{hi}"].append(
                    roc_auc(scores[m], y[te][m]))
    return {
        "auroc_mean": (float(np.mean(results["overall"]))
                       if results["overall"] else None),
        "auroc_std": (float(np.std(results["overall"]))
                      if results["overall"] else None),
        "buckets": {k: (float(np.mean(v)) if v else None)
                    for k, v in results["buckets"].items()},
        "per_C": {str(C): (float(np.mean(v)) if v else None)
                  for C, v in per_C.items()},
        "selected_C": selected_Cs,
        "n": int(len(y)),
    }


def main(argv=None):
    p = argparse.ArgumentParser(prog="vep")
    p.add_argument("--fasta", required=True)
    p.add_argument("--variants", required=True)
    p.add_argument("--run-dir", required=True,
                   help="pretraining run dir: model_config.json and a "
                        "params.npz export, the port's checkpoints/ or a JAX "
                        "run's Orbax checkpoints/ (EMA weights preferred)")
    p.add_argument("--out", default="vep_embeddings")
    p.add_argument("--seq-len", type=int, default=131072)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--svm", action="store_true",
                   help="run the SVM eval after the dump, on the same "
                        "device")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    args = p.parse_args(argv)

    import torch.distributed as dist

    from caduceus_tpu_torch.params import load_run_dir
    from caduceus_tpu_torch.parallel.mesh import launch_device, launch_env

    cfg, params = load_run_dir(args.run_dir)
    rank, world, local = launch_env()
    device = args.device
    owns = world > 1 and not dist.is_initialized()
    if world > 1:
        if device == "cuda":
            device = launch_device(local)
            torch.cuda.set_device(device)
        if owns:
            dist.init_process_group("gloo", init_method="env://", rank=rank,
                                    world_size=world)
    dump_embeddings(cfg, params, args.fasta, args.variants, args.out,
                    seq_len=args.seq_len, batch_size=args.batch_size,
                    rank=rank, world_size=world, device=device)
    if world > 1:
        dist.barrier()   # every rank's shard is written
    if rank == 0:
        path = combine_embeddings(args.out, world)
        print(json.dumps({"embeddings": path}))
        if args.svm:
            print(json.dumps(svm_eval(path, device=device)))
    if owns:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
