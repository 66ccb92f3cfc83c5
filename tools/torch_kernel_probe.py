#!/usr/bin/env python3
"""Design probe of the port's K1 (masked_moments), K2
(masked_centered_sumsq), K3 (hll_register_max) and K4 (hist16) kernels
on one CUDA card: what sets their pace.

Run from the repository root on a machine with one CUDA card:

    python3 tools/torch_kernel_probe.py

It builds tools/torch_kernel_probe.cu (the shipped
deequ_tpu_torch/csrc/kernels.cu plus two probe kernels) with nvcc into
deequ_tpu_torch/build/, prints the card's nvidia-smi line, then one JSON
line per measurement, median CUDA-event times in ms:
  timer    the event time of a call that launches nothing;
  hist16   at 4,194,304 normal rows (every 11th excluded) and at 4096
           rows a block: the kernel with its shipped flush, with a 32-bit
           atomic per non-zero bin and every block scanning from word 0,
           and with no global atomics (the rows alone, what no flush can
           beat);
  hll      at 4,194,304 hashed codes: the shipped launch and a kernel
           that loads the same bytes the same way and does nothing else;
  masked_moments, masked_centered_sumsq
           at 4,194,304 float64 rows (every 11th masked): the shipped
           wrapper; the first design (scalar loads under the mask, a
           second fold launch); the new design with its three folds,
           (a) the last block folds (shipped, launched here without the
           wrapper), (b) one cooperative launch with a grid sync, (c) a
           second launch, and (a) with four quads in flight instead of
           two, and (a) with the ticket drawn between two fences, as
           first written, instead of by one acquire-release atomic; and
           the new design's loads alone (the load floor) with
           two and four quads in flight, and the same bytes read flat
           (consecutive double2 of x a lane, then consecutive mask words).
           For K1 also a leaner row (a NaN flag, one compare each for
           min and max, the count by __popc a quad) and its sum alone;
           for both the partials with no fold. Every fold of the new
           design, and the leaner row, must give the shipped kernel's
           bits;
each with the L2 evicted before every launch by writing 256 MB
(chip_smoke.py's timer: the dirty lines are written back while the
kernel runs) and by reading 256 MB (clean lines). The probe kernels run
without the output's zero fill; their outputs are not read. The
shipped kernels' exactness is chip_smoke.py's to check.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

BATCH = 1 << 22


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("torch_kernel_probe: no CUDA device\n")
        return 2
    import chip_smoke
    from deequ_tpu_torch.ops import cuda_build
    from deequ_tpu_torch.ops import cuda_kernels as ck
    from deequ_tpu_torch.ops.sketches import hll

    print(chip_smoke.nvidia_smi_line(), flush=True)
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(cuda_build.BUILD_DIR, "libkernel_probe.so")
    cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", lib_path,
           os.path.join(REPO, "tools", "torch_kernel_probe.cu")]
    subprocess.run(cmd, check=True)
    lib = ctypes.CDLL(lib_path)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.probe_hist16_flush.argtypes = [ptr, ptr, i64, i64, i32, ptr, i32, ptr]
    lib.probe_hll_load_floor.argtypes = [ptr, ptr, i64, i32, ptr, ptr]
    lib.probe_moments.argtypes = [i32, i32, ptr, ptr, i64, i32, i32, ptr, ptr, ptr, ptr, ptr]
    lib.dq_masked_moments.argtypes = [ptr, i32, ptr, i64, i32, i32, ptr, ptr, ptr, ptr]
    lib.dq_centered_sumsq.argtypes = [ptr, i32, ptr, i64, i32, i32, ptr, ptr, ptr, ptr, ptr]

    device = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(device).cuda_stream
    sms = ck.sm_count(device)
    write_evict = chip_smoke.Timer(torch, device)

    class ReadEvict(chip_smoke.Timer):
        def ms(self, fn, reps: int = 30) -> float:
            fn()
            torch.cuda.synchronize()
            events = []
            for _ in range(reps):
                self.flush.max()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                events.append((start, end))
            torch.cuda.synchronize()
            return statistics.median(s.elapsed_time(e) for s, e in events)

    read_evict = ReadEvict(torch, device)

    def both(fn):
        return {"write_evict_ms": write_evict.ms(fn), "read_evict_ms": read_evict.ms(fn)}

    def emit(obj):
        print(json.dumps(obj), flush=True)

    def ok(err):
        if err:
            raise RuntimeError(f"probe launch failed with cudaError {err}")

    emit({"probe": "timer", "empty_call": both(lambda: torch.empty(1, device=device))})

    rng = np.random.default_rng(7)
    for n in (BATCH, sms * 4096):
        x = torch.from_numpy(rng.normal(3.0, 2.0, n)).to(device)
        valid = np.ones(n, dtype=bool)
        valid[::11] = False
        live = torch.from_numpy(valid).to(device)
        _head, window, grid = ck.hist16_plan(n, sms, x.data_ptr())
        out = torch.zeros(ck.HIST_BINS, dtype=torch.int32, device=device)
        row = {"probe": "hist16", "rows": n, "window": window, "grid": grid,
               "shipped_wrapper": both(lambda: ck.hist16(x, live))}
        for flush, name in ((0, "flush_shipped"), (1, "flush_32bit_from_word_0"),
                            (2, "no_flush_atomics")):
            row[name] = both(lambda: ok(lib.probe_hist16_flush(
                x.data_ptr(), live.data_ptr(), n, window, grid, out.data_ptr(), flush, stream)))
        emit(row)

    codes = torch.from_numpy(hll.pack_codes(rng.integers(0, BATCH, BATCH),
                                            np.ones(BATCH, dtype=bool))).to(device)
    valid = np.ones(BATCH, dtype=bool)
    valid[::11] = False
    m = torch.from_numpy(valid).to(device)
    _head, grid = ck.hll_plan(BATCH, sms, codes.data_ptr())
    regs = torch.zeros(ck.N_REGISTERS, dtype=torch.int32, device=device)
    emit({"probe": "hll", "rows": BATCH, "grid": grid,
          "shipped_wrapper": both(lambda: ck.hll_register_max(codes, m)),
          "load_floor": both(lambda: ok(lib.probe_hll_load_floor(
              codes.data_ptr(), m.data_ptr(), BATCH, grid, regs.data_ptr(), stream)))})

    x = torch.from_numpy(rng.normal(3.0, 2.0, BATCH)).to(device)
    avg = x[m].mean()
    head, grid = ck.moments_plan(BATCH, x.data_ptr(), 8)
    scratch = torch.empty(4 * 8 * 132, dtype=torch.float64, device=device)
    tickets = torch.zeros(1, dtype=torch.int32, device=device)
    for kernel, name in ((0, "masked_moments"), (1, "masked_centered_sumsq")):
        out = torch.empty(4, dtype=torch.float64, device=device)
        shipped = (ck.masked_moments(x, m) if kernel == 0
                   else ck.masked_centered_sumsq(x, m, avg).reshape(1))

        def design(d):
            return lambda: ok(lib.probe_moments(
                kernel, d, x.data_ptr(), m.data_ptr(), BATCH, head, grid, avg.data_ptr(),
                scratch.data_ptr(), tickets.data_ptr(), out.data_ptr(), stream))

        def last_block():
            if kernel == 0:
                ok(lib.dq_masked_moments(x.data_ptr(), 0, m.data_ptr(), BATCH, head, grid,
                                         scratch.data_ptr(), tickets.data_ptr(),
                                         out.data_ptr(), stream))
            else:
                ok(lib.dq_centered_sumsq(x.data_ptr(), 0, m.data_ptr(), BATCH, head, grid,
                                         avg.data_ptr(), scratch.data_ptr(),
                                         tickets.data_ptr(), out.data_ptr(), stream))

        row = {"probe": name, "rows": BATCH, "grid": grid, "threads": ck.MOMENTS_THREADS}
        for label, fn, same_bits in (
            ("shipped_wrapper", None, None),
            ("fold_last_block", last_block, True),
            ("fold_grid_sync", design(3), True),
            ("fold_second_launch", design(2), True),
            ("fold_last_block_4_quads", design(1), True),
            ("fold_last_block_fences", design(10), True),
            ("earlier_design", design(0), False),
            ("load_floor", design(4), None),
            ("load_floor_4_quads", design(5), None),
            ("load_floor_flat", design(6), None),
            ("lean_row", design(7) if kernel == 0 else None, True),
            ("sum_only", design(8) if kernel == 0 else None, None),
            ("partials_no_fold", design(9), None),
        ):
            if label in ("lean_row", "sum_only") and kernel:
                continue
            if fn is None:
                row[label] = both(lambda: ck.masked_moments(x, m) if kernel == 0
                                  else ck.masked_centered_sumsq(x, m, avg))
                continue
            fn()
            torch.cuda.synchronize()
            got = out[:shipped.numel()]
            if same_bits and not torch.equal(got, shipped):
                raise AssertionError(f"{name} {label}: {got.tolist()} != {shipped.tolist()}")
            if same_bits is False and not torch.allclose(got, shipped, rtol=1e-10, atol=0.0):
                raise AssertionError(f"{name} {label}: {got.tolist()} vs {shipped.tolist()}")
            row[label] = both(fn)
        emit(row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
