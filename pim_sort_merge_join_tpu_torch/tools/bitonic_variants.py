"""Time `csrc/bitonic_sort.cu` built with other tile sizes, on the card.

Usage, from the root of a checkout, on a machine with an NVIDIA H100 and
the CUDA toolkit:

    python3 -m pim_sort_merge_join_tpu_torch.tools.bitonic_variants

Each variant sets the tile (``2^LOG_TILE`` elements of a block), the
elements a thread holds in registers (``2^LOG_ITEMS``; the block has
tile / items threads), the blocks per SM that bound its registers, and
whether the five lowest tile bits go by warp shuffles
(``SMJ_BITONIC_SHUFFLE``, on unless a variant says 0; without them the
lowest round holds a thread's own 16 neighbours, and the pass's last store
and a tile's first load are no longer contiguous across a warp); builds the source alone with those `-D` flags (all builds started
together), checks the sort against `torch.sort` of the packed pairs at
every width from 2 to 2^21, and times with CUDA events (median of 7 after
a warmup, every variant twice, in turns): the whole sort of 2^21 pairs,
and of its launches the tiles' own sort (the first pass) and stage 2^21's
strided and local pass. It prints one line per variant with the registers
`ptxas` reports and the launches of a 2^21 sort, then the card's name and
power limit. The first variant is the one the port ships.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
import tempfile

import torch

from pim_sort_merge_join_tpu_torch.ops.kernels import bitonic_sort as bs
from pim_sort_merge_join_tpu_torch.ops.kernels import build

VARIANTS = {
    "tile8192_items16_2perSM (shipped)": dict(SMJ_BITONIC_LOG_TILE=13, SMJ_BITONIC_LOG_ITEMS=4,
                                              SMJ_BITONIC_BLOCKS_PER_SM=2),
    "tile8192_items16_2perSM_no_shuffle": dict(SMJ_BITONIC_LOG_TILE=13, SMJ_BITONIC_LOG_ITEMS=4,
                                               SMJ_BITONIC_BLOCKS_PER_SM=2, SMJ_BITONIC_SHUFFLE=0),
    "tile8192_items8_1perSM": dict(SMJ_BITONIC_LOG_TILE=13, SMJ_BITONIC_LOG_ITEMS=3,
                                   SMJ_BITONIC_BLOCKS_PER_SM=1),
    "tile8192_items16_1perSM": dict(SMJ_BITONIC_LOG_TILE=13, SMJ_BITONIC_LOG_ITEMS=4,
                                    SMJ_BITONIC_BLOCKS_PER_SM=1),
    "tile8192_items16_3perSM": dict(SMJ_BITONIC_LOG_TILE=13, SMJ_BITONIC_LOG_ITEMS=4,
                                    SMJ_BITONIC_BLOCKS_PER_SM=3),
    "tile4096_items16_2perSM": dict(SMJ_BITONIC_LOG_TILE=12, SMJ_BITONIC_LOG_ITEMS=4,
                                    SMJ_BITONIC_BLOCKS_PER_SM=2),
    "tile4096_items8_2perSM": dict(SMJ_BITONIC_LOG_TILE=12, SMJ_BITONIC_LOG_ITEMS=3,
                                   SMJ_BITONIC_BLOCKS_PER_SM=2),
    "tile4096_items8_4perSM": dict(SMJ_BITONIC_LOG_TILE=12, SMJ_BITONIC_LOG_ITEMS=3,
                                   SMJ_BITONIC_BLOCKS_PER_SM=4),
    "tile4096_items16_4perSM": dict(SMJ_BITONIC_LOG_TILE=12, SMJ_BITONIC_LOG_ITEMS=4,
                                    SMJ_BITONIC_BLOCKS_PER_SM=4),
    "tile16384_items16_1perSM": dict(SMJ_BITONIC_LOG_TILE=14, SMJ_BITONIC_LOG_ITEMS=4,
                                     SMJ_BITONIC_BLOCKS_PER_SM=1),
    "tile2048_items8_8perSM": dict(SMJ_BITONIC_LOG_TILE=11, SMJ_BITONIC_LOG_ITEMS=3,
                                   SMJ_BITONIC_BLOCKS_PER_SM=8),
}
TURNS = 2  # every variant is timed this many times, in turns
WIDTH = 1 << 21


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


def equal_to_library(keys, vals) -> bool:
    """The sorted pairs are one sequence whatever the network: compare with
    `torch.sort` of the packed elements."""
    want = bs.unpack_pair32(torch.sort(bs.pack_pair32(keys, vals) ^ bs._MIN64).values ^ bs._MIN64)
    got = bs.bitonic_sort_cuda(keys, vals)
    return torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def one_pass_ms(p: bs.BitonicPass, keys, vals, buf, pack: bool) -> float:
    """One launch of the schedule alone, on whatever the buffers hold."""
    def run():
        bs.launch_passes([p], keys, vals, buf, keys, vals, pack_first=pack, unpack_last=False)

    return time_ms(run)


def main() -> int:
    if not torch.cuda.is_available():
        print("bitonic_variants: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    src = str(build.CSRC_DIR / "bitonic_sort.cu")
    shipped = bs.LOG_TILE
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for i, defines in enumerate(VARIANTS.values()):
            cmd = [build._nvcc(), *build.NVCC_FLAGS, *(f"-D{k}={v}" for k, v in defines.items()),
                   "-Xptxas", "-v", "-o", f"{tmp}/v{i}.so", src]
            procs[i] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True)
        gen = torch.Generator(device="cuda").manual_seed(1)
        keys = torch.randint(-(2**31), 2**31, (WIDTH,), generator=gen, device="cuda").to(torch.int32)
        vals = torch.arange(WIDTH, dtype=torch.int32, device="cuda")
        buf = torch.empty(WIDTH, dtype=torch.int64, device="cuda")
        failed = False
        built = {}
        for i, (name, defines) in enumerate(VARIANTS.items()):
            out = procs[i].communicate()[0]
            if procs[i].returncode:
                print(f"{name}: build failed\n{out[-3000:]}")
                failed = True
                continue
            regs = [int(line.split("Used ")[1].split()[0]) for line in out.splitlines()
                    if "Used " in line]
            spills = [line.strip() for line in out.splitlines() if "spill" in line]
            built[name] = (i, defines, regs, spills)
        for turn in range(TURNS):
            for name, (i, defines, regs, spills) in built.items():
                # Load this variant in place of the port's library.
                build._lib = ctypes.CDLL(f"{tmp}/v{i}.so")
                bs._fns.clear()
                bs.LOG_TILE = defines["SMJ_BITONIC_LOG_TILE"]
                passes = bs.bitonic_schedule(WIDTH, bs.LOG_TILE)
                rec = {"turn": turn, "launches": len(passes)}
                if turn == 0:
                    equal = all(
                        equal_to_library(keys[: 1 << m].contiguous(), vals[: 1 << m].contiguous())
                        for m in range(1, 22)
                    )
                    failed |= not equal
                    rec.update(equal_to_library=equal, registers=regs, spills=spills)
                rec.update(
                    sort_ms=time_ms(lambda: bs.bitonic_sort_cuda(keys, vals)),
                    first_pass_ms=one_pass_ms(passes[0], keys, vals, buf, True),
                    last_strided_ms=one_pass_ms(passes[-2], keys, vals, buf, False),
                    last_local_ms=one_pass_ms(passes[-1], keys, vals, buf, False),
                )
                print(name, {k: round(v, 4) if isinstance(v, float) else v for k, v in rec.items()},
                      flush=True)
        build._lib = None
        bs._fns.clear()
        bs.LOG_TILE = shipped
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return int(failed)


if __name__ == "__main__":
    sys.exit(main())
