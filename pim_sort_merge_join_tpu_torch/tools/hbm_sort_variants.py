"""Time `csrc/hbm_sort.cu` built with other compile-time sizes, on the card.

Usage, from the root of a checkout, on a machine with an NVIDIA H100 and
the CUDA toolkit:

    python3 -m pim_sort_merge_join_tpu_torch.tools.hbm_sort_variants

Each variant sets the elements per thread and the threads per run-sort and
merge block (so RUN and TILE) and the blocks per SM the compiler must
allow, builds the source alone with those `-D` flags (all builds started
together), checks three small sorts against the plain version, and times
with CUDA events (median of 7 after a warmup), on random keys: the 20M
pair-32 sort whole and as phase A and phase B, the 20M packed-32 sort with
one int32 payload, and the 10M packed-32 and wide sorts with four int64
payloads; and the column gather alone at 20M x 3 int32, 10M x 4 int32 and
10M x 4 int64. It prints one line per variant with the registers `ptxas`
reports, then the card's name and power limit. The first variant is the
one the port ships.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
import tempfile

import numpy as np
import torch

from pim_sort_merge_join_tpu_torch.ops.kernels import build
from pim_sort_merge_join_tpu_torch.ops.kernels import hbm_sort as hs

VARIANTS = {
    "items16_run512_tile256 (shipped)": dict(SMJ_ITEMS=16, SMJ_RUN_THREADS=512, SMJ_TILE_THREADS=256),
    "items16_run1024_tile256": dict(SMJ_ITEMS=16, SMJ_RUN_THREADS=1024, SMJ_TILE_THREADS=256,
                                    SMJ_RUN_BLOCKS_PER_SM=1),
    "items16_run512_tile128": dict(SMJ_ITEMS=16, SMJ_RUN_THREADS=512, SMJ_TILE_THREADS=128,
                                   SMJ_TILE_BLOCKS_PER_SM=8),
    "items16_run512_tile512": dict(SMJ_ITEMS=16, SMJ_RUN_THREADS=512, SMJ_TILE_THREADS=512,
                                   SMJ_TILE_BLOCKS_PER_SM=2),
    "items16_run512_tile256_3perSM": dict(SMJ_ITEMS=16, SMJ_RUN_THREADS=512, SMJ_TILE_THREADS=256,
                                          SMJ_TILE_BLOCKS_PER_SM=3),
    "items8_run1024_tile512": dict(SMJ_ITEMS=8, SMJ_RUN_THREADS=1024, SMJ_TILE_THREADS=512),
    "items8_run1024_tile256": dict(SMJ_ITEMS=8, SMJ_RUN_THREADS=1024, SMJ_TILE_THREADS=256,
                                   SMJ_TILE_BLOCKS_PER_SM=8),
}


def time_ms(fn, setup=lambda: None, reps: int = 7) -> float:
    fn(setup())
    times = []
    for _ in range(reps):
        arg = setup()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn(arg)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("hbm_sort_variants: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    src = str(build.CSRC_DIR / "hbm_sort.cu")
    shipped = (hs.RUN, hs.TILE)
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for i, defines in enumerate(VARIANTS.values()):
            cmd = [build._nvcc(), *build.NVCC_FLAGS, *(f"-D{k}={v}" for k, v in defines.items()),
                   "-Xptxas", "-v", "-o", f"{tmp}/v{i}.so", src]
            procs[i] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

        rng = np.random.default_rng(0)
        n, m, small_n = 20_000_000, 10_000_000, 300_001
        dev = "cuda"
        keys = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(dev)
        pos = torch.arange(n, dtype=torch.int32, device=dev)
        payload = torch.from_numpy(rng.integers(0, n, n).astype(np.int32)).to(dev)
        k10 = torch.from_numpy(rng.permutation(m).astype(np.int32)).to(dev)
        cols = tuple(torch.from_numpy(rng.integers(0, 2**40, m)).to(dev) for _ in range(4))
        cols32 = tuple(c.to(torch.int32) for c in cols)
        pos_perm = torch.randperm(n, device=dev).to(torch.int32)
        small = (torch.from_numpy(rng.integers(-5, 5, small_n).astype(np.int32)).to(dev),
                 torch.from_numpy(rng.integers(-(2**31), 2**31, small_n).astype(np.int32)).to(dev))
        checks = [(small, 2), (small, 1), ((cols[0][:small_n].contiguous(), small[0]), 1)]
        wants = [hs.hbm_sort_plain(ops, nk) for ops, nk in checks]

        failed = False
        for i, (name, defines) in enumerate(VARIANTS.items()):
            out = procs[i].communicate()[0]
            if procs[i].returncode:
                print(f"{name}: build failed\n{out[-2000:]}")
                failed = True
                continue
            regs = [int(line.split("Used ")[1].split()[0]) for line in out.splitlines() if "Used " in line]
            # Load this variant in place of the port's library.
            build._lib = ctypes.CDLL(f"{tmp}/v{i}.so")
            hs._fns.clear()
            hs.RUN = defines["SMJ_ITEMS"] * defines["SMJ_RUN_THREADS"]
            hs.TILE = defines["SMJ_ITEMS"] * defines["SMJ_TILE_THREADS"]
            equal = all(
                torch.equal(g, w)
                for (ops, nk), want in zip(checks, wants) for g, w in zip(hs.hbm_sort(ops, nk), want)
            )
            failed |= not equal
            runs = hs.chunk_sort(keys, pos, hs.KIND_PAIR32)[0]
            rec = {
                "equal_to_plain": equal, "run": hs.RUN, "tile": hs.TILE,
                "passes_20M": len(hs.pass_schedule(n)[1]),
                "pair32_20M_ms": time_ms(lambda _: hs.hbm_sort((keys, pos), 2)),
                "phase_a_ms": time_ms(lambda _: hs.chunk_sort(keys, pos, hs.KIND_PAIR32)),
                "phase_b_ms": time_ms(lambda k: hs.merge_passes(k, None, hs.KIND_PAIR32, n),
                                      setup=runs.clone),
                "packed32_20M_1_payload_ms": time_ms(lambda _: hs.hbm_sort((keys, payload))),
                "packed32_10M_4xint64_ms": time_ms(lambda _: hs.hbm_sort((k10,) + cols)),
                "wide_10M_4xint64_ms": time_ms(lambda _: hs.hbm_sort((cols[0],) + cols)),
                "gather_20M_3xint32_ms": time_ms(lambda _: hs.gather(pos_perm, (keys, pos, payload))),
                "gather_10M_4xint32_ms": time_ms(lambda _: hs.gather(k10, cols32)),
                "gather_10M_4xint64_ms": time_ms(lambda _: hs.gather(k10, cols)),
                "registers_per_kernel": regs,
            }
            print(name, {k: round(v, 3) if isinstance(v, float) else v for k, v in rec.items()}, flush=True)
            del runs
        build._lib = None
        hs._fns.clear()
        hs.RUN, hs.TILE = shipped
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return int(failed)


if __name__ == "__main__":
    sys.exit(main())
