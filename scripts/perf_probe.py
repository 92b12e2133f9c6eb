#!/usr/bin/env python
"""Component-level performance probe for the sketch + distance hot paths.

Each mode prints one JSON object per measurement; device modes need a
GPU and print the card's name and power limit first.

  --host          native FASTA parse (one thread, then a thread pool) and
                  WordTapeFeeder assembly (Mbase/s) on the config-1 corpus
  --step          the stream step per batch (ms) at L3K10 and L2K8
  --nblocks       config-1 sketch wall (bench.write_corpus, 256 x 2 Mb,
                  L3K10) with 16 and with 64 blocks per batch, in turns
  --rates         the cost model of dist_engine._use_walk: host walk
                  and device membership-matmul walls at seven strip
                  shapes (a tiny tile, config 1, config-4-like, related
                  genomes, outbreak isolates, a config-5 tile), which is
                  faster, what the default model chooses, and the
                  model's constants fitted to them

Usage: python scripts/perf_probe.py [--host] [--step] [--nblocks] [--rates]
       [--genomes 256] [--length 2000000] [--n-blocks 64]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def emit(stage: str, **kv):
    print(json.dumps({"stage": stage, **kv}), flush=True)


def require_gpu() -> None:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"perf_probe: no GPU (JAX platform "
                         f"{dev.platform!r})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    emit("device", platform=dev.platform, kind=dev.device_kind,
         count=len(jax.devices()), nvidia_smi=smi, jax=jax.__version__)


def l3k10():
    from rabbitkssd.params import KssdParams

    return KssdParams(half_k=10, half_subk=6, drlevel=3)


def probe_host(files: list[str]) -> None:
    from concurrent.futures import ThreadPoolExecutor

    from rabbitkssd.engine import sketcher as S
    from rabbitkssd.native import fasta_packed, load_native

    if load_native() is None:
        emit("parse", skipped="no native toolchain")
        return
    t0 = time.perf_counter()
    total = sum(fasta_packed(p, 0)[1] for p in files)
    emit("parse", mbase_per_s=total / 1e6 / (time.perf_counter() - t0),
         mbase=total / 1e6)
    # the sketch scheduler parses files on a bounded thread pool (the
    # native parser releases the GIL)
    for t in (1, 2, 4, 8, 16):
        if t > (os.cpu_count() or 1):
            break
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=t) as ex:
            tot = sum(r[1] for r in ex.map(lambda p: fasta_packed(p, 0),
                                           files))
        emit(f"parse_pool:t{t}",
             mbase_per_s=tot / 1e6 / (time.perf_counter() - t0))
    t0 = time.perf_counter()
    feeder = S.WordTapeFeeder((fasta_packed(p, 0) for p in files),
                              n_blocks=64, block=1 << 17,
                              halo=S.aligned_halo(l3k10()))
    nb = sum(1 for _ in feeder)
    emit("feeder", mbase_per_s=total / 1e6 / (time.perf_counter() - t0),
         batches=nb)


def _step_ms(sk, words, dexc, valid_upto, iters: int = 20) -> float:
    """Mean time of one stream step over a synced loop of ``iters``."""
    import jax
    import jax.numpy as jnp

    out = sk._step(words, dexc, sk.table, *sk._fresh_buffers(),
                   jnp.int32(0), valid_upto)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = sk._step(words, dexc, sk.table, *out, jnp.int32(0),
                       valid_upto)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters * 1e3


def probe_step(n_blocks: int) -> None:
    """The stream step per batch (random bases) at L3K10 and L2K8."""
    import jax
    import jax.numpy as jnp

    from rabbitkssd.engine import sketcher as S
    from rabbitkssd.ops.kmer import pad_exceptions
    from rabbitkssd.params import KssdParams
    from rabbitkssd.shuffle import generate_shuffle

    rng = np.random.default_rng(0)
    block = 1 << 17
    for name, (k, s, l) in (("L3K10", (10, 6, 3)), ("L2K8", (8, 6, 2))):
        params = KssdParams(half_k=k, half_subk=s, drlevel=l)
        shuf = generate_shuffle(k, s, l)
        halo = S.aligned_halo(params)
        nw = block // 16 + halo // 16 + 2
        words = jax.device_put(rng.integers(
            0, 2 ** 32, size=(n_blocks, nw), dtype=np.uint64
        ).astype(np.uint32))
        dexc = jax.device_put(pad_exceptions(
            np.empty(0, np.int32), n_blocks * (block + halo)))
        vu = jnp.int32(n_blocks * block)
        sk = S.DeviceSketcher(params, shuf.shuffled_dim,
                              n_blocks=n_blocks, block=block)
        t0 = time.perf_counter()
        sk.prewarm()
        compile_s = time.perf_counter() - t0
        ms = _step_ms(sk, words, dexc, vu)
        emit(f"step:{name}", n_blocks=n_blocks, ms_per_batch=ms,
             mbase_per_s=n_blocks * block / 1e3 / ms, compile_s=compile_s)


def probe_nblocks(files: list[str], shuffled_dim) -> object:
    """Config-1 sketch walls at 16 and 64 blocks per batch, in turns."""
    from rabbitkssd.engine.sketcher import DeviceSketcher

    mb = sum(os.path.getsize(p) for p in files) / 1e6
    sketchers: dict = {}
    out = None
    for nb in (16, 64, 64, 16, 16, 64):
        if nb not in sketchers:
            sketchers[nb] = DeviceSketcher(l3k10(), shuffled_dim,
                                           n_blocks=nb)
            sketchers[nb].prewarm()
        sk = sketchers[nb]
        t0 = time.perf_counter()
        out = sk.sketch_files(files)
        wall = time.perf_counter() - t0
        emit(f"sketch:n_blocks{nb}", wall_s=wall, fasta_mb_per_s=mb / wall,
             budget=sk.last_budget)
    return out


def clustered(n: int, per: int, cluster: int, shared: float, space: int,
              seed: int) -> list[np.ndarray]:
    """Synthetic sorted sketches: clusters of ``cluster`` genomes share
    a ``shared`` fraction of their ``per`` hashes (the construction of
    scripts/config5_run.py)."""
    rng = np.random.default_rng(seed)
    dt = np.uint32 if space <= 1 << 32 else np.uint64
    n_shared = int(per * shared)
    out = []
    for _ in range(-(-n // cluster)):
        core = rng.integers(0, space, size=n_shared, dtype=dt)
        for _ in range(cluster):
            own = rng.integers(0, space, size=per - n_shared, dtype=dt)
            out.append(np.unique(np.concatenate([core, own])))
    return out[:n]


def _mean_s(f, reps: int) -> float:
    f()
    t0 = time.perf_counter()
    for _ in range(reps):
        f()
    return (time.perf_counter() - t0) / reps


def time_strip(name: str, hashes: list[np.ndarray], matmul: bool) -> dict:
    """Walk and matmul walls of one all-vs-all strip (every genome
    against every genome, as run_alldist's below-one-block path counts
    it), the join and vocabulary that _use_walk prices, and the choice
    it makes with the default rates."""
    from rabbitkssd.engine import dist_engine as E

    n = len(hashes)
    csr = E._CsrIndex.from_hashes(hashes)
    pairs = csr.side_pairs(0, n)
    lp = csr.walk_layout(pairs)
    join, width = int(lp[1][-1]), len(lp[1][0])
    walk = np.empty((n, n), np.int32)
    reps = 5 if join < 1e8 else 2
    walk_s = _mean_s(lambda: csr.walk(walk, lp), reps)
    row = dict(n=n, join=join, vocab=width, flop=2.0 * n * n * width,
               walk_s=walk_s, matmul_s=None,
               default_choice="walk" if E._use_walk(lp, n, n) else "matmul")
    if matmul:
        os.environ["KSSD_HOST_JOIN_MAX"] = "0"
        try:
            mm = csr.counts(pairs, pairs, n, n)
            row["matmul_s"] = _mean_s(
                lambda: csr.counts(pairs, pairs, n, n), reps)
        finally:
            del os.environ["KSSD_HOST_JOIN_MAX"]
        if not np.array_equal(mm, walk):
            raise AssertionError(f"{name}: matmul counts differ from the "
                                 "walk's")
        row["faster"] = ("walk" if walk_s < row["matmul_s"] else "matmul")
    emit(f"strip:{name}", **row)
    return row


def probe_rates(sketches) -> None:
    """Walk and matmul walls at seven strip shapes, from a tiny tile to a
    config-5 tile, and the fits of dist_engine._use_walk's cost model:
    walk = fixed + join / rate; matmul = fixed + vocab * per-column
    cost + flop / rate."""
    c1 = [s.hashes for s in sketches.sketches]
    shapes = [
        # fixed costs: 8 genomes x 64 hashes, the smallest vocab bucket
        ("tiny", [h[:64] for h in c1[:8]], True),
        # config 1: 256 bacteria, L3K10
        ("config1", c1, True),
        # config 4: a few mammal-size sketches (L3K12, ~300k hashes per
        # GB-scale genome, 64-bit hashes), half of each shared
        ("config4", clustered(4, 300_000, 4, 0.5, 1 << 48, 4), True),
        # related genomes, 10 % of each sketch its own: 64 x 20k hashes
        ("dense", clustered(64, 20_000, 64, 0.9, 1 << 28, 5), True),
        # outbreak isolates of one strain: 500 hashes, 98 % shared
        ("outbreak256", clustered(256, 500, 256, 0.98, 1 << 28, 7), True),
        ("outbreak1024", clustered(1024, 500, 1024, 0.98, 1 << 28, 8),
         True),
        # one config-5 tile: 2048 genomes x 1.5k hashes in strain
        # clusters of 50 sharing 55 % (scripts/config5_run.py); its
        # matmul (~1e13 flop) is not run
        ("config5_tile", clustered(2048, 1500, 50, 0.55, 1 << 28, 6),
         False),
    ]
    rows = {name: time_strip(name, h, mm) for name, h, mm in shapes}
    tiny = rows["tiny"]
    ran = [r for r in rows.values() if r["matmul_s"] is not None]
    top = max(rows.values(), key=lambda r: r["join"])
    wr = (top["join"] - tiny["join"]) / (top["walk_s"] - tiny["walk_s"])
    wf = tiny["walk_s"] - tiny["join"] / wr
    mf = tiny["matmul_s"]
    # per-column cost from the widest vocabulary (its flops are few),
    # flop rate from the most flops net of fixed + column costs
    wide = max(ran, key=lambda r: r["vocab"] / r["flop"])
    col_s = (wide["matmul_s"] - mf) / wide["vocab"]
    big = max(ran, key=lambda r: r["flop"])
    mr = big["flop"] / max(big["matmul_s"] - mf - col_s * big["vocab"],
                           1e-9)
    emit("fit", walk_fixed_s=wf, walk_increments_per_s=wr,
         matmul_fixed_s=mf, matmul_col_s=col_s, matmul_flop_per_s=mr,
         from_shapes=[top["n"], wide["n"], big["n"]])
    for name, r in rows.items():
        walk = wf + r["join"] / wr
        mm = mf + col_s * r["vocab"] + r["flop"] / mr
        emit(f"fit:{name}", walk_s=walk, matmul_s=mm,
             fit_choice="walk" if walk < mm else "matmul",
             faster=r.get("faster"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--genomes", type=int, default=256)
    ap.add_argument("--length", type=int, default=2_000_000)
    ap.add_argument("--n-blocks", type=int, default=64,
                    help="blocks per batch for --step")
    ap.add_argument("--host", action="store_true")
    ap.add_argument("--step", action="store_true")
    ap.add_argument("--nblocks", action="store_true")
    ap.add_argument("--rates", action="store_true")
    args = ap.parse_args()

    import bench
    from rabbitkssd.engine.sketcher import DeviceSketcher
    from rabbitkssd.shuffle import generate_shuffle

    if args.step or args.nblocks or args.rates:
        require_gpu()
    with tempfile.TemporaryDirectory(prefix="kssd_probe_") as work:
        files = []
        if args.host or args.nblocks or args.rates:
            lst = bench.write_corpus(os.path.join(work, "c1"),
                                     args.genomes, args.length)
            with open(lst) as f:
                files = [ln.strip() for ln in f if ln.strip()]
        if args.host:
            probe_host(files)
        if args.step:
            probe_step(args.n_blocks)
        if args.nblocks or args.rates:
            table = generate_shuffle(10, 6, 3).shuffled_dim
            if args.nblocks:
                sketches = probe_nblocks(files, table)
            else:
                sketches = DeviceSketcher(l3k10(), table).sketch_files(files)
            if args.rates:
                probe_rates(sketches)
    return 0


if __name__ == "__main__":
    sys.exit(main())
