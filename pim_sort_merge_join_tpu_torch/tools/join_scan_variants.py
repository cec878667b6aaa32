"""Time `csrc/join_scan.cu` built with other block sizes, on the card.

Usage, from the root of a checkout, on a machine with an NVIDIA H100 and
the CUDA toolkit:

    python3 -m pim_sort_merge_join_tpu_torch.tools.join_scan_variants

Each variant sets the threads per block and the elements per thread (so
the block), or the resident threads per SM that bound each pass's
registers, builds the source alone with those `-D` flags (all builds
started together), checks both kernels against their plain halves on
merged random keys with dead rows, on one run that spans every block and
on an all-dead input, each at lengths around the block's edges, and times
with CUDA events (median of 7 after a warmup, every variant twice, in
turns): forward and backward over
20M int32 keys (the fused 10M query's shape: unique keys per table, 15% of
the rows dead) and over 2M int64 keys. It prints one line per variant
with the registers `ptxas` reports, then the card's name and power limit.
The first variant is the one the port ships.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
import tempfile

import torch

from pim_sort_merge_join_tpu_torch.ops.kernels import build
from pim_sort_merge_join_tpu_torch.ops.kernels import join_scan as js

VARIANTS = {
    "threads512_items8 (shipped)": dict(JS_THREADS=512, JS_ITEMS=8),
    "threads512_items8_1024perSM": dict(JS_THREADS=512, JS_ITEMS=8, JS_FORWARD_THREADS_PER_SM=1024,
                                        JS_BACKWARD_THREADS_PER_SM=1024),
    "threads512_items8_fw2048_bw1536": dict(JS_THREADS=512, JS_ITEMS=8,
                                            JS_FORWARD_THREADS_PER_SM=2048,
                                            JS_BACKWARD_THREADS_PER_SM=1536),
    "threads512_items4": dict(JS_THREADS=512, JS_ITEMS=4),
    "threads512_items16": dict(JS_THREADS=512, JS_ITEMS=16),
    "threads512_items16_1024perSM": dict(JS_THREADS=512, JS_ITEMS=16, JS_FORWARD_THREADS_PER_SM=1024,
                                         JS_BACKWARD_THREADS_PER_SM=1024),
    "threads256_items8": dict(JS_THREADS=256, JS_ITEMS=8),
    "threads256_items16": dict(JS_THREADS=256, JS_ITEMS=16),
    "threads128_items8": dict(JS_THREADS=128, JS_ITEMS=8),
    "threads1024_items8": dict(JS_THREADS=1024, JS_ITEMS=8),
    "threads1024_items4": dict(JS_THREADS=1024, JS_ITEMS=4),
}
PASSES = 2  # every variant is timed this many times, in turns


def time_ms(fn, reps: int = 7) -> float:
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_registers(ptxas_output: str) -> dict[str, int]:
    """Registers per kernel from `ptxas -v`: pass and key width -> count."""
    regs, name = {}, None
    for line in ptxas_output.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            name = (("forward" if "forward" in mangled else "backward")
                    + ("_int64" if "kernelIl" in mangled else "_int32"))
        elif "Used " in line and name:
            regs[name] = int(line.split("Used ")[1].split()[0])
    return regs


def merged_keys(n_per_table: int, dtype: torch.dtype, seed: int):
    """The merge sort's output for two tables of unique keys, 15% of the
    rows dead: ``(mkeys, mpos, cap1)`` on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    sent = torch.iinfo(dtype).max
    keys = torch.cat([
        torch.randperm(3 * n_per_table // 2, generator=gen, device="cuda")[:n_per_table]
        for _ in range(2)
    ])
    keys = torch.where(keys < 3 * n_per_table // 20, sent, keys).to(dtype)
    mkeys, order = torch.sort(keys, stable=True)
    return mkeys, order.to(torch.int32), n_per_table


def equal_to_plain(mkeys, mpos, cap1) -> bool:
    cand, m2 = js.join_scan_forward(mkeys, mpos, cap1)
    want_cand, want_m2 = js.join_scan_forward_plain(mkeys, mpos, cap1)
    dest, num_out = js.join_scan_backward(mkeys, want_cand, want_m2)
    want_dest, want_num = js.join_scan_backward_plain(mkeys, want_cand, want_m2)
    return (torch.equal(cand, want_cand) and torch.equal(m2, want_m2)
            and torch.equal(dest, want_dest) and int(num_out) == int(want_num))


def checks(block: int):
    """Small inputs around the block's edges, for both key widths."""
    cases = []
    for n in (block - 1, block, block + 1, 33 * block + 5):
        for dtype in (torch.int32, torch.int64):
            mkeys, mpos, cap1 = merged_keys(n, dtype, seed=n)
            cases.append((mkeys[:n].contiguous(), mpos[:n].contiguous(), cap1))
            pos = torch.arange(n, dtype=torch.int32, device="cuda")
            cases.append((torch.full((n,), 42, dtype=dtype, device="cuda"), pos, 2 * n // 3))
            cases.append((torch.full((n,), torch.iinfo(dtype).max, dtype=dtype, device="cuda"),
                          pos, n // 2))
    return cases


def main() -> int:
    if not torch.cuda.is_available():
        print("join_scan_variants: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    src = str(build.CSRC_DIR / "join_scan.cu")
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for i, defines in enumerate(VARIANTS.values()):
            cmd = [build._nvcc(), *build.NVCC_FLAGS, *(f"-D{k}={v}" for k, v in defines.items()),
                   "-Xptxas", "-v", "-o", f"{tmp}/v{i}.so", src]
            procs[i] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True)

        mk32, mp32, cap32 = merged_keys(10_000_000, torch.int32, seed=1)
        mk64, mp64, cap64 = merged_keys(1_000_000, torch.int64, seed=2)
        fw32 = js.join_scan_forward_plain(mk32, mp32, cap32)
        fw64 = js.join_scan_forward_plain(mk64, mp64, cap64)

        failed = False
        built = {}
        for i, (name, defines) in enumerate(VARIANTS.items()):
            out = procs[i].communicate()[0]
            if procs[i].returncode:
                print(f"{name}: build failed\n{out[-3000:]}")
                failed = True
                continue
            built[name] = (i, defines, kernel_registers(out))
        for turn in range(PASSES):
            for name, (i, defines, regs) in built.items():
                # Load this variant in place of the port's library.
                build._lib = ctypes.CDLL(f"{tmp}/v{i}.so")
                js._fns.clear()
                block = defines["JS_THREADS"] * defines["JS_ITEMS"]
                rec = {"turn": turn, "block": block}
                if turn == 0:
                    equal = all(equal_to_plain(*case) for case in checks(block))
                    equal &= equal_to_plain(mk32, mp32, cap32) and equal_to_plain(mk64, mp64, cap64)
                    failed |= not equal
                    rec.update(equal_to_plain=equal, registers=regs)
                rec.update(
                    forward_20M_int32_ms=time_ms(lambda: js.join_scan_forward(mk32, mp32, cap32)),
                    backward_20M_int32_ms=time_ms(lambda: js.join_scan_backward(mk32, *fw32)),
                    forward_2M_int64_ms=time_ms(lambda: js.join_scan_forward(mk64, mp64, cap64)),
                    backward_2M_int64_ms=time_ms(lambda: js.join_scan_backward(mk64, *fw64)),
                )
                print(name, {k: round(v, 4) if isinstance(v, float) else v for k, v in rec.items()},
                      flush=True)
        build._lib = None
        js._fns.clear()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return int(failed)


if __name__ == "__main__":
    sys.exit(main())
