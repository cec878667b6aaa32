"""Time `csrc/radix_sort.cu` built with other block shapes, on the card.

Usage, from the root of a checkout, on a machine with an NVIDIA H100 and
the CUDA toolkit:

    python3 -m pim_sort_merge_join_tpu_torch.tools.radix_variants

Two families of variants, each built from the source alone with `-D` flags
(all builds started together):

- the tile sort (`radix_tile_sort`): the block that sorts a tile (``tile =
  threads x items``, one block shape per build), the resident threads per SM
  that bound its registers, `__match_any_sync` in place of the ballots
  that find the lanes of one digit, and the digit width read at run time
  where the shipped kernels know their 8 bits at compile time;
- the global sort (`xla_lsd_radix_sort`): its block (threads x items = its
  tile) and blocks per SM, and two builds that time a pass's halves apart
  and sort nothing (`SMJ_LSD_ABLATE`: no ranking and no look-back; no
  device-memory loads and stores); then, on the shipped build, other digit
  widths (a run-time argument): 7, 9 and 11 bits beside 8.

Each variant is checked against the plain version (the tile sort on six
tiles with sentinels and negative keys; the global sort against a stable
`torch.sort` of the bits the passes read, at 2^20 + 5 elements and at
`33 * tile + 5`), then timed with CUDA events (median of 7 after a warmup,
every variant twice, in turns) at the fused query's merge-sort shape,
20004864 `(key, position)` int32 pairs with 15% sentinels. It prints one
line per variant with the registers and spills `ptxas` reports, then the
shipped global sort's kernels under `torch.profiler`, then the card's name
and power limit. The first variant of each family is the one the port ships.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
import tempfile

import torch

from pim_sort_merge_join_tpu_torch.ops.kernels import build
from pim_sort_merge_join_tpu_torch.ops.kernels import radix_sort as rs

N = 20004864  # the fused 10M query's merge sort, padded to runs of 8192
TURNS = 2

# name -> (tile, threads, items, extra defines)
TILE_VARIANTS = {
    "tile512_64x8 (shipped)": (512, 64, 8, {}),
    "tile512_32x16": (512, 32, 16, {}),
    "tile512_128x4": (512, 128, 4, {}),
    "tile512_256x2": (512, 256, 2, {}),
    "tile512_64x8_match_any": (512, 64, 8, {"SMJ_RADIX_MATCH_ANY": 1}),
    "tile2048_128x16 (shipped)": (2048, 128, 16, {}),
    "tile2048_256x8": (2048, 256, 8, {}),
    "tile2048_512x4": (2048, 512, 4, {}),
    "tile2048_64x32": (2048, 64, 32, {}),
    "tile2048_128x16_match_any": (2048, 128, 16, {"SMJ_RADIX_MATCH_ANY": 1}),
    "tile2048_128x16_2048_per_sm": (2048, 128, 16, {"SMJ_RADIX_TILE_THREADS_PER_SM": 2048}),
    "tile2048_128x16_run_time_digit_width": (2048, 128, 16, {"SMJ_RADIX_GENERIC_ONLY": 1}),
    "tile8192_512x16 (shipped)": (8192, 512, 16, {}),
    "tile8192_512x16_1_per_sm": (8192, 512, 16, {"SMJ_RADIX_TILE_THREADS_PER_SM": 512}),
    "tile8192_1024x8": (8192, 1024, 8, {}),
    "tile8192_256x32": (8192, 256, 32, {}),
}
# name -> (threads, items, blocks per SM[, extra defines])
LSD_VARIANTS = {
    "lsd_512x16_2_per_sm (shipped)": (512, 16, 2),
    "lsd_512x16_1_per_sm": (512, 16, 1),
    "lsd_512x16_2_per_sm_run_time_digit_width": (512, 16, 2, {"SMJ_RADIX_GENERIC_ONLY": 1}),
    "lsd_512x16_2_per_sm_no_ranking_no_look_back": (512, 16, 2, {"SMJ_LSD_ABLATE": 1}),
    "lsd_512x16_2_per_sm_no_loads_no_stores": (512, 16, 2, {"SMJ_LSD_ABLATE": 2}),
    "lsd_256x16_4_per_sm": (256, 16, 4),
    "lsd_512x8_2_per_sm": (512, 8, 2),
    "lsd_1024x8_1_per_sm": (1024, 8, 1),
    "lsd_1024x8_2_per_sm": (1024, 8, 2),
    "lsd_1024x16_1_per_sm": (1024, 16, 1),
    "lsd_384x16_2_per_sm": (384, 16, 2),
    "lsd_256x32_2_per_sm": (256, 32, 2),
}
DIGIT_WIDTHS = ((8, 32), (8, 25), (7, 28), (9, 25), (11, 32), (11, 22))  # (digit_bits, key_bits)


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


def load_variant(path: str, configs, lsd) -> None:
    """Load one build in place of the port's library, with the module's
    mirrors of its compile-time shapes."""
    build._lib = ctypes.CDLL(path)
    rs._fns.clear()
    rs.TILE_CONFIGS = configs
    rs.LSD_THREADS, rs.LSD_ITEMS = lsd


def keys_with_sentinels(n: int, gen, lo: int, hi: int) -> torch.Tensor:
    key = torch.randint(lo, hi, (n,), generator=gen, device="cuda").to(torch.int32)
    key[torch.rand(n, generator=gen, device="cuda") < 0.15] = 2**31 - 1
    return key


def tile_sort_equal(tile: int, gen) -> bool:
    n = 6 * tile
    ok = True
    for lo, hi, digit_bits, key_bits, nops in ((0, 1 << 25, 8, 32, 2), (-(2**31), 2**31, 8, 32, 3),
                                               (0, 1 << 12, 4, 12, 1)):
        ops = (keys_with_sentinels(n, gen, lo, hi),) + tuple(
            torch.randint(-(2**31), 2**31, (n,), generator=gen, device="cuda").to(torch.int32)
            for _ in range(nops - 1))
        kw = dict(tile=tile, digit_bits=digit_bits, key_bits=key_bits)
        got, want = rs.radix_tile_sort(ops, **kw), rs.radix_tile_sort_plain(ops, **kw)
        ok &= all(torch.equal(g, w) for g, w in zip(got, want))
    return ok


def lsd_sort_equal(n: int, gen, digit_bits: int = 8, key_bits: int = 32) -> bool:
    key = keys_with_sentinels(n, gen, -(2**31), 2**31)
    val = torch.randint(-(2**31), 2**31, (n,), generator=gen, device="cuda").to(torch.int32)
    seen = (key.long() & 0xFFFFFFFF) & ((1 << -(-key_bits // digit_bits) * digit_bits) - 1)
    order = torch.sort(seen, stable=True).indices
    got = rs.xla_lsd_radix_sort((key, val), digit_bits=digit_bits, key_bits=key_bits)
    return torch.equal(got[0], key[order]) and torch.equal(got[1], val[order])


def ptxas_report(out: str, kernel: str, generic: bool = False) -> dict:
    """Registers and spill bytes of the instance of ``kernel`` that 8-bit
    digits run: the 8-bit one, or the run-time one where it is built alone."""
    lines = out.splitlines()
    instance = "Li0EE" if generic else "Li8EE"
    for i, line in enumerate(lines):
        if "Compiling entry" in line and kernel in line and instance in line:
            regs = [int(x.split("Used ")[1].split()[0]) for x in lines[i:i + 5] if "Used " in x]
            spill = [x.strip() for x in lines[i:i + 5]
                     if "spill" in x and "0 bytes spill stores" not in x]
            return {"registers": regs[0] if regs else None, "spills": spill}
    return {}


def profile_shipped(key, pos) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rs.xla_lsd_radix_sort((key, pos))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        rs.xla_lsd_radix_sort((key, pos))
        rs.radix_tile_sort((key, pos), tile=2048)
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t, c = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.end - e.time_range.start, c + 1)
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
        print(f"  {t / 1e3:8.3f} ms  x{c:<3d} {name[:110]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("radix_variants: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    src = str(build.CSRC_DIR / "radix_sort.cu")
    shipped = (rs.TILE_CONFIGS, (rs.LSD_THREADS, rs.LSD_ITEMS))
    check_library = rs._check_library
    builds = {}
    for name, (tile, threads, items, extra) in TILE_VARIANTS.items():
        builds[name] = {"SMJ_RADIX_VARIANT_TILE": tile, "SMJ_RADIX_VARIANT_THREADS": threads,
                        "SMJ_RADIX_VARIANT_ITEMS": items, **extra}
    for name, (threads, items, per_sm, *extra) in LSD_VARIANTS.items():
        # One small tile block, so the build is the global sort's alone.
        builds[name] = {"SMJ_RADIX_VARIANT_TILE": 512, "SMJ_RADIX_VARIANT_THREADS": 128,
                        "SMJ_RADIX_VARIANT_ITEMS": 4, "SMJ_LSD_THREADS": threads,
                        "SMJ_LSD_ITEMS": items, "SMJ_LSD_BLOCKS_PER_SM": per_sm,
                        **(extra[0] if extra else {})}
    failed = False
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for i, (name, defines) in enumerate(builds.items()):
            cmd = [build._nvcc(), *build.NVCC_FLAGS, *(f"-D{k}={v}" for k, v in defines.items()),
                   "-Xptxas", "-v", "-o", f"{tmp}/v{i}.so", src]
            procs[name] = (i, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True))
        gen = torch.Generator(device="cuda").manual_seed(1)
        key = keys_with_sentinels(N, gen, 0, 30_000_000)
        pos = torch.arange(N, dtype=torch.int32, device="cuda")
        built = {}
        for name, (i, proc) in procs.items():
            out = proc.communicate()[0]
            if proc.returncode:
                print(f"{name}: build failed\n{out[-2000:]}")
                failed = True
                continue
            kernel = "radix_tile_kernel" if name in TILE_VARIANTS else "radix_pass_kernel"
            built[name] = (f"{tmp}/v{i}.so",
                           ptxas_report(out, kernel, "SMJ_RADIX_GENERIC_ONLY" in builds[name]))
        for turn in range(TURNS):
            for name, (path, report) in built.items():
                rec = {"turn": turn}
                if name in TILE_VARIANTS:
                    tile, threads, items, _ = TILE_VARIANTS[name]
                    load_variant(path, ((tile, threads, items),), (512, 16))
                    # A variant is no library for the module's own shapes to be held to.
                    rs._check_library = lambda: None
                    if turn == 0:
                        equal = tile_sort_equal(tile, gen)
                        failed |= not equal
                        rec.update(equal_to_plain=equal, **report)
                    rec["ms"] = time_ms(lambda: rs.radix_tile_sort((key, pos), tile=tile))
                else:
                    threads, items = LSD_VARIANTS[name][:2]
                    load_variant(path, ((512, 128, 4),), (threads, items))
                    rs._check_library = lambda: None
                    if turn == 0 and "SMJ_LSD_ABLATE" in builds[name]:
                        rec.update(equal_to_plain="not a sort", **report)
                    elif turn == 0:
                        equal = (lsd_sort_equal((1 << 20) + 5, gen)
                                 and lsd_sort_equal(33 * threads * items + 5, gen))
                        failed |= not equal
                        rec.update(equal_to_plain=equal, **report)
                    rec["ms"] = time_ms(lambda: rs.xla_lsd_radix_sort((key, pos)))
                print(name, {k: round(v, 4) if isinstance(v, float) else v for k, v in rec.items()},
                      flush=True)
    rs._check_library = check_library
    build._lib = None
    rs._fns.clear()
    rs.TILE_CONFIGS, (rs.LSD_THREADS, rs.LSD_ITEMS) = shipped
    for digit_bits, key_bits in DIGIT_WIDTHS:
        mask = (1 << min(key_bits, 31)) - 1
        k = key & mask
        equal = lsd_sort_equal((1 << 20) + 5, gen, digit_bits, key_bits)
        failed |= not equal
        times = [time_ms(lambda: rs.xla_lsd_radix_sort((k, pos), digit_bits=digit_bits,
                                                       key_bits=key_bits)) for _ in range(TURNS)]
        print(f"lsd shipped, digit_bits={digit_bits} key_bits={key_bits} "
              f"({-(-key_bits // digit_bits)} passes, keys & {mask:#x}):",
              {"equal_to_plain": equal, "ms": [round(t, 4) for t in times]}, flush=True)
    print("library: stable torch.sort of the key",
          [round(time_ms(lambda: torch.sort(key, stable=True)), 4) for _ in range(TURNS)])
    print("shipped build under torch.profiler (one global sort, one tile sort at 2048):")
    profile_shipped(key, pos)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return int(failed)


if __name__ == "__main__":
    sys.exit(main())
