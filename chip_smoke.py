#!/usr/bin/env python3
"""Drive stylemc_torch's serving path on one CUDA card and check it.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing one JSON object per line; any failure raises and the
script exits non-zero:

  env     card name, nvidia-smi power limit, torch/CUDA versions, TF32 flags
          (both turned off: the fp32 policy compares against fp32 references)
  build   nvcc build of the kernel library from the checkout's sources
  kernel  the upsample2x kernel against its plain torch version at every
          ToRGB chain shape of FFHQ-256 at batch 16, the 1024 px plane and
          an odd shape; max |err| <= 1e-5; kernel, plain, library-call and
          bound times (device time: CUDA events around calls queued behind
          a sleep kernel), and the wrapper's time over back-to-back calls,
          which includes its host cost
  serve   full-width FFHQ-256 generator (random weights from a seed) saved
          as a native .npz, BatchEditor.from_files + warmup, an HTTP server
          answering /edit and /stats; images/s at batch 16 and 64; where
          one batch-16 call's device time goes, by kernel name and by
          layer (profiler)
  parity  two seeds rendered on the card and on the CPU agree within ±1
  clis    generate_w → w_s_converter → generate_fromS as subprocesses

Each path that renders (the HTTP requests, the throughput calls, the
parity render on the card, each CLI) is driven with the kernel's launch
count set to 0 just before it and read just after; each must show the
kernel launched 6 times per synthesis call.

Then the card's nvidia-smi line, a {"kernels": [...]} line and, last,
{"ok": true, "device": {...}}. Without a CUDA device, or outside the
repository, it exits non-zero before printing any result.
"""

from __future__ import annotations

import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, fp32 without tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
KERNEL_TOL = 1e-5
CHAIN_SHAPES = [(16, 3, h, h) for h in (4, 8, 16, 32, 64, 128)]
EXTRA_SHAPES = [(1, 3, 512, 512), (2, 5, 6, 10)]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def upsample_bound(shape):
    """(ms, 'bytes' | 'operations'): the least time an H100 takes for the
    2x upsample of `shape` — each input read once (4 B/elem), each output
    written once (16 B per input elem), 18 flops per input element (two
    2-tap passes at 3 flops per produced value)."""
    n, c, h, w = shape
    elems = n * c * h * w
    t_bytes = 20 * elems / HBM_BYTES_PER_S
    t_ops = 18 * elems / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def synthesis_flop(cfg, useful: bool = False) -> int:
    """Flops (2 per multiply-add) of one image's synthesis call. conv1 is
    3x3, torgb 1x1. Each conv0 is the 3x3 kernel composed with the 4x4 FIR
    (6x6): as the port runs it (pad_dilate) over the zero-stuffed input at
    full resolution, 36 taps per output pixel; with `useful`, only the
    taps that meet a non-zero input, 9 per output pixel (the polyphase
    form's count)."""
    conv0_taps = 9 if useful else 36
    total = 0
    for res in cfg.block_resolutions:
        c_out = cfg.channels(res)
        c_in = cfg.channels(res // 2) if res > 4 else c_out
        if res > 4:
            total += 2 * conv0_taps * c_in * c_out * res * res
        total += 2 * 9 * c_out * c_out * res * res
        total += 2 * c_out * cfg.img_channels * res * res
    return total


def library_weight(taps, channels, device):
    """The depthwise [C, 1, 4, 4] weight of `library_upsample`: the outer
    product of the reversed taps."""
    import torch

    t = torch.tensor(taps[::-1], dtype=torch.float32, device=device)
    return torch.outer(t, t)[None, None].repeat(channels, 1, 1, 1)


def library_upsample(x, weight):
    """One PyTorch call computing the same function: a depthwise transposed
    convolution. A yardstick only; the port never calls it."""
    import torch.nn.functional as F

    return F.conv_transpose2d(x, weight, stride=2, padding=1,
                              groups=x.shape[1])


def event_ms(fn, iters=50, warmup=5) -> float:
    """Mean time per call between CUDA events over `iters` back-to-back
    calls: includes the host's cost where it exceeds the device's."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20) -> float:
    """Device time per call of `fn` (which must not synchronise): CUDA
    events around `iters` calls queued behind a sleep kernel, so the host's
    launch cost is hidden and the events time the device's work alone,
    gaps between kernels included. The sleep grows until it outlasts the
    queuing."""
    import torch

    fn()
    torch.cuda.synchronize()
    cycles = 20_000_000
    for _ in range(6):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        marks[0].record()
        torch.cuda._sleep(cycles)
        marks[1].record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        queued_ms = (time.perf_counter() - t0) * 1e3
        marks[2].record()
        marks[2].synchronize()
        if marks[0].elapsed_time(marks[1]) > 1.5 * queued_ms:
            return marks[1].elapsed_time(marks[2]) / iters
        cycles *= 4
    raise RuntimeError("the calls could not be queued behind a sleep "
                       "kernel; does the function synchronise?")


# ------------------------------------------------------------------ phases


def phase_env(torch):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi_line()
    emit({"phase": "env", "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "note": "TF32 off for the fp32 policy"})
    return smi


def phase_build():
    from stylemc_torch.ops.kernels import upfirdn2d as kup
    from stylemc_torch.ops.kernels.build import library_dir

    t0 = time.perf_counter()
    kup._library()
    seconds = time.perf_counter() - t0
    log = (library_dir([kup.SOURCE]) / "build.log").read_text()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": seconds, "ptxas": ptxas})


def phase_kernel(torch):
    from stylemc_torch.ops import setup_filter_np
    from stylemc_torch.ops.kernels.upfirdn2d import (
        _canonical_taps, _launch, upsample2d_kernel, upsample2d_plain)

    f = setup_filter_np([1, 3, 3, 1])
    taps = _canonical_taps(f, 4.0, False)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for shape in CHAIN_SHAPES + EXTRA_SHAPES:
        x = torch.randn(shape, generator=gen, device="cuda")
        weight = library_weight(taps, shape[1], "cuda")
        got = upsample2d_kernel(x, f)
        want = upsample2d_plain(x, taps)
        lib = library_upsample(x, weight)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        lib_err = float((lib - want).abs().max())
        bound_ms, bound_by = upsample_bound(shape)
        fns = {"kernel": lambda: _launch(x, taps),
               "plain": lambda: upsample2d_plain(x, taps),
               "library": lambda: library_upsample(x, weight)}
        row = {"shape": list(shape), "max_abs_err": err,
               "library_max_abs_err": lib_err,
               "bound_ms": bound_ms, "bound_by": bound_by}
        for key, fn in fns.items():
            row[f"{key}_ms"] = device_ms(fn)
        row["wrapper_event_ms"] = event_ms(lambda: upsample2d_kernel(x, f))
        emit({"phase": "kernel", **row})
        if not err <= KERNEL_TOL:
            raise AssertionError(f"upsample2x disagrees with its plain "
                                 f"version at {shape}: {err} > {KERNEL_TOL}")
        if not lib_err <= KERNEL_TOL:
            raise AssertionError(f"library yardstick computes another "
                                 f"function at {shape}: {lib_err}")
        rows.append(row)
    return rows


def _get(url):
    with urllib.request.urlopen(url, timeout=600) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _decode(body):
    import numpy as np
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))


def make_network(torch, tmp):
    """Full-width FFHQ-256 generator with random weights from seed 0, saved
    as a native .npz, and a seeded direction npz."""
    import numpy as np

    from stylemc_torch.io import save_native
    from stylemc_torch.models.stylegan2.generator import (
        S_TRAINABLE_SPACE_CHANNELS, GeneratorConfig, init_generator_params)

    cfg = GeneratorConfig(img_resolution=256)
    params = init_generator_params(torch.Generator().manual_seed(0), cfg,
                                   device="cpu")
    net = os.path.join(tmp, "ffhq256_seed0.npz")
    save_native(net, cfg, params)
    d = np.zeros((1, 26, 512), np.float32)
    rng = np.random.RandomState(1)
    for row in S_TRAINABLE_SPACE_CHANNELS:
        d[:, row] = rng.randn(512).astype(np.float32) * 0.5
    direction = os.path.join(tmp, "direction_d0.npz")
    np.savez(direction, s=d)
    return cfg, net, direction


def count_launches(fn):
    """(fn(), upsample2x launches during it), the count set to 0 just
    before the call."""
    from stylemc_torch.ops.kernels.upfirdn2d import upsample2d_kernel

    upsample2d_kernel.launches = 0
    out = fn()
    return out, upsample2d_kernel.launches


def record_launches(paths, cfg, path, launches, synthesis_calls) -> None:
    """Keep a path's launch count and hold it to one launch per upper
    block of each synthesis call."""
    per_call = len(cfg.block_resolutions) - 1
    paths[path] = {"launches": launches, "synthesis_calls": synthesis_calls}
    if launches != per_call * synthesis_calls:
        raise AssertionError(
            f"{path}: upsample2x launched {launches} times over "
            f"{synthesis_calls} synthesis calls, not {per_call} per call")


def phase_serve(torch, net, direction, smi, paths):
    import numpy as np

    from stylemc_torch.cli.serve import build_server
    from stylemc_torch.serve import BatchEditor

    t0 = time.perf_counter()
    editor = BatchEditor.from_files(net, direction=direction,
                                    directions={"d0": direction},
                                    max_batch=64, device="cuda")
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    editor.warmup()
    warmup_s = time.perf_counter() - t0
    res = editor.cfg.img_resolution
    chunk = min(editor.pipeline_chunk or 64, 64)

    server, service = build_server(editor, host="127.0.0.1", port=0,
                                   coalesce_ms=3.0, max_batch=64)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def requests():
        t0 = time.perf_counter()
        r1 = _get(f"{base}/edit?seeds=1-4&pairs=1")
        t1 = time.perf_counter()
        r2 = _get(f"{base}/edit?seeds=1-16&power=2.0&direction=d0")
        return r1, r2, [t1 - t0, time.perf_counter() - t1]

    try:
        (r1, r2, request_s), launches = count_launches(requests)
        st3, _, body3 = _get(f"{base}/stats")
        stats = json.loads(body3)
        st4, _, body4 = _get(f"{base}/healthz")
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(timeout=30)
    if thread.is_alive():
        raise AssertionError("HTTP server thread did not stop")

    (st1, ct1, body1), (st2, ct2, body2) = r1, r2
    img1, img2 = _decode(body1), _decode(body2)
    checks = {
        "status_200": (st1, st2, st3, st4) == (200, 200, 200, 200),
        "jpeg": ct1 == ct2 == "image/jpeg",
        "pairs_shape": img1.shape == (4 * res, 2 * res, 3),
        "d0_shape": img2.shape == (16 * res, res, 3),
        "left_ne_right": bool(np.abs(img1[:, :res].astype(int)
                                     - img1[:, res:].astype(int)).max() > 0),
        "stats": stats.get("requests") == 2 and stats.get("errors") == 0,
        "healthz": body4 == b"ok",
    }
    emit({"phase": "serve", "launches": launches, "load_s": load_s,
          "warmup_s": warmup_s, "request_s": request_s, "stats": stats,
          "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"serve checks failed: {checks}")
    # pairs=1 renders original and edit: two synthesis calls per chunk
    record_launches(paths, editor.cfg, "http", launches,
                    2 * -(-4 // chunk) + -(-16 // chunk))

    # throughput of edit_styles, fp32, in pipeline chunks
    styles = editor.styles_from_seeds(list(range(64)))
    rates = {}
    torch.cuda.reset_peak_memory_stats()

    def throughput():
        for b in (16, 64):
            editor.edit_styles(styles[:b])
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                out = editor.edit_styles(styles[:b], change_power=2.0)
                times.append(time.perf_counter() - t0)
                assert out.shape == (b, res, res, 3)
            rates[str(b)] = {
                "images_per_s": [b / t for t in times],
                "median_images_per_s": b / statistics.median(times)}

    _, launches = count_launches(throughput)
    record_launches(paths, editor.cfg, "throughput", launches,
                    4 * (-(-16 // chunk) + -(-64 // chunk)))
    flop = synthesis_flop(editor.cfg)
    useful = synthesis_flop(editor.cfg, useful=True)
    for r in rates.values():
        r["achieved_tflop_per_s"] = r["median_images_per_s"] * flop / 1e12
        r["useful_tflop_per_s"] = r["median_images_per_s"] * useful / 1e12
    emit({"phase": "serve_throughput", "precision": "fp32",
          "card": smi, "pipeline_chunk": editor.pipeline_chunk,
          "up_conv_impl": editor.cfg.up_conv_impl,
          "synthesis_flop_per_image": flop,
          "useful_flop_per_image": useful, "launches": launches,
          "peak_mem_bytes": torch.cuda.max_memory_allocated(), **rates})

    def one_call():
        return editor.edit_styles(styles[:16], change_power=2.0)

    emit({"phase": "breakdown", "card": smi,
          **device_breakdown(torch, one_call)})
    emit({"phase": "layers", "card": smi,
          **layer_breakdown(torch, one_call, batch=16)})
    return editor


def profiled(torch, fn, record_shapes: bool = False):
    """Profile one call of `fn` (after an untraced one): (profile, host
    wall ms, CUDA-event span ms, device busy ms). With `record_shapes` the
    host's ops are traced too, with their input shapes. The profiler can
    miss device events, so a trace whose busy time is under half the span
    is taken again, up to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if record_shapes:
        activities.append(ProfilerActivity.CPU)
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with profile(activities=activities,
                     record_shapes=record_shapes) as prof:
            t0 = time.perf_counter()
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy_ms = sum(evt.time_range.elapsed_us() / 1e3
                      for evt in prof.events()
                      if evt.device_type == DeviceType.CUDA)
        span_ms = start.elapsed_time(end)
        if busy_ms >= 0.5 * span_ms:
            return prof, wall_ms, span_ms, busy_ms
    raise RuntimeError(f"the profiler recorded {busy_ms} ms of device "
                       f"time in a {span_ms} ms span, three times")


def device_breakdown(torch, fn, top=10):
    """Where the device time of one call of `fn` goes: CUDA kernel and copy
    time by name, their sum (device busy) against the host wall time of
    the call, and so the device's idle share. The profiler's own host cost
    is inside the wall time."""
    from torch.autograd import DeviceType

    prof, wall_ms, span_ms, busy_ms = profiled(torch, fn)
    by_name = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            ms, calls = by_name.get(evt.name, (0.0, 0))
            by_name[evt.name] = (ms + evt.time_range.elapsed_us() / 1e3,
                                 calls + 1)
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {"wall_ms": wall_ms, "span_ms": span_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms,
            "upsample2x_ms": sum(ms for name, (ms, _) in rows
                                 if "upsample2x" in name),
            "top": [{"name": name[:100], "ms": ms, "calls": calls,
                     "share": ms / busy_ms}
                    for name, (ms, calls) in rows[:top]]}


def _kernels(evt):
    """The device kernels that a host op and its children launched."""
    out = list(evt.kernels)
    for child in evt.cpu_children:
        out += _kernels(child)
    return out


def conv_layer(x_shape, w_shape):
    """(layer, output resolution) of a synthesis convolution from its
    input and weight shapes: a 6x6 weight is a conv0 (3x3 composed with
    the 4x4 FIR, run over the zero-stuffed input), 3x3 a conv1, 1x1 a
    torgb; a 4x4 FIR over [O*I, 1, 3, 3] weight planes composes a conv0's
    kernel."""
    kh = w_shape[2]
    res = x_shape[2] - kh + 1
    if x_shape[1] == 1 and w_shape[:2] == [1, 1]:
        return "conv0_kernel_compose", None
    return {6: "conv0", 3: "conv1", 1: "torgb"}.get(kh, f"conv{kh}x{kh}"), res


def layer_breakdown(torch, fn, batch):
    """Device time of one call of `fn` by synthesis layer, measured: the
    profiler records each aten::convolution with its input shapes and the
    device time of the kernels it launched; `conv_layer` names the layer.
    Rates are flops over that device time, in the form the port runs and,
    for conv0, in useful flops (the 9 of its 36 taps per output pixel
    that meet a non-zero input)."""
    prof, wall_ms, span_ms, busy_ms = profiled(torch, fn, record_shapes=True)
    rows = {}
    for evt in prof.events():
        if evt.name != "aten::convolution" or not evt.input_shapes:
            continue
        x_shape, w_shape = list(evt.input_shapes[0]), list(evt.input_shapes[1])
        layer, res = conv_layer(x_shape, w_shape)
        kernels = _kernels(evt)
        row = rows.setdefault((layer, res), {
            "layer": layer, "res": res, "x": x_shape, "w": w_shape,
            "calls": 0, "device_ms": 0.0, "flop": 0, "kernels": {}})
        row["calls"] += 1
        row["device_ms"] += sum(k.duration for k in kernels) / 1e3
        if res is not None:
            o, i, kh, kw = w_shape
            row["flop"] += 2 * x_shape[0] * o * i * kh * kw * res * res
        for k in kernels:
            row["kernels"][k.name[:80]] = row["kernels"].get(k.name[:80], 0) + 1
    by_layer = {}
    for row in rows.values():
        row["share"] = row["device_ms"] / busy_ms
        if row["flop"] and row["device_ms"]:
            row["tflop_per_s"] = row["flop"] / row["device_ms"] / 1e9
            if row["layer"] == "conv0":
                row["useful_tflop_per_s"] = row["tflop_per_s"] / 4
        total = by_layer.setdefault(row["layer"], {"device_ms": 0.0,
                                                   "calls": 0})
        total["device_ms"] += row["device_ms"]
        total["calls"] += row["calls"]
    conv_ms = sum(t["device_ms"] for t in by_layer.values())
    for total in by_layer.values():
        total["share"] = total["device_ms"] / busy_ms
    return {"batch": batch, "device_busy_ms": busy_ms, "span_ms": span_ms,
            "by_layer": by_layer,
            "outside_convolutions_ms": busy_ms - conv_ms,
            "rows": sorted(rows.values(), key=lambda r: -r["device_ms"])}


def phase_parity(editor, net, direction, paths):
    import numpy as np

    from stylemc_torch.serve import BatchEditor

    cpu = BatchEditor.from_files(net, direction=direction, max_batch=2,
                                 device="cpu")
    t0 = time.perf_counter()
    want, cpu_launches = count_launches(
        lambda: cpu.edit_seeds([1, 2], change_power=2.0, pairs=True))
    cpu_s = time.perf_counter() - t0
    got, launches = count_launches(
        lambda: editor.edit_seeds([1, 2], change_power=2.0, pairs=True))
    diff = int(np.abs(got.astype(int) - want.astype(int)).max())
    emit({"phase": "parity", "max_abs_u8_diff": diff, "cpu_s": cpu_s,
          "shape": list(got.shape), "launches": launches,
          "cpu_launches": cpu_launches})
    if diff > 1:
        raise AssertionError(f"cuda vs cpu uint8 renders differ by {diff}")
    if cpu_launches != 0:
        raise AssertionError("the CPU render launched the CUDA kernel")
    record_launches(paths, editor.cfg, "parity", launches, 2)


# Runs a CLI module as `python -m` does, then prints the kernel's launch
# count in that process as its last line.
CLI_RUNNER = """\
import json, runpy, sys
from stylemc_torch.ops.kernels.upfirdn2d import upsample2d_kernel
sys.argv = sys.argv[1:]
upsample2d_kernel.launches = 0
try:
    runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
except SystemExit as e:
    if e.code not in (None, 0):
        raise
print(json.dumps({"launches": upsample2d_kernel.launches}))
"""


def phase_clis(editor, net, direction, tmp, paths):
    import numpy as np

    def run(name, synthesis_calls, *args):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", CLI_RUNNER,
                               f"stylemc_torch.cli.{name}", *args], cwd=ROOT,
                              timeout=600, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{name} exited {proc.returncode}:\n"
                               f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
        launches = json.loads(proc.stdout.strip().splitlines()[-1])["launches"]
        record_launches(paths, editor.cfg, f"cli_{name}", launches,
                        synthesis_calls)
        return time.perf_counter() - t0

    w_file = os.path.join(tmp, "projected_w.npz")
    s_file = os.path.join(tmp, "input.npz")
    outdir = os.path.join(tmp, "out")
    os.makedirs(outdir)
    prompt = "smiling face"
    np.savez(os.path.join(outdir, "direction_smiling_face.npz"),
             s=np.load(direction)["s"])
    # generate_w and w_s_converter render nothing; generate_fromS renders
    # its 8 items in one batch, original and edit: two synthesis calls
    secs = [run("generate_w", 0, "--network", net, "--seeds", "1-8",
                "--trunc", "0.7", "--out_file", w_file),
            run("w_s_converter", 0, "--network", net, "--projected-w", w_file,
                "--out_file", s_file),
            run("generate_fromS", 2, "--network", net, "--s_input", s_file,
                "--outdir", outdir, "--text_prompt", prompt)]
    w, s = np.load(w_file)["w"], np.load(s_file)["s"]
    ref = editor.styles_from_seeds(list(range(1, 9))).cpu().numpy()
    jpegs = sorted(f for f in os.listdir(outdir) if f.endswith(".jpeg"))
    imgs = []
    for name in jpegs:
        with open(os.path.join(outdir, name), "rb") as fh:
            imgs.append(_decode(fh.read()))
    res = editor.cfg.img_resolution
    checks = {
        "w_shape": w.shape == (8, 14, 512),
        "s_shape": s.shape == (8, 26, 512),
        "s_matches_editor": bool(np.allclose(s, ref, rtol=1e-4, atol=1e-4)),
        "jpeg_names": jpegs == [f"smiling_face_{i:03d}.jpeg"
                                for i in range(8)],
        "jpeg_shapes": all(a.shape == (res, 2 * res, 3) for a in imgs),
        "left_ne_right": all(np.abs(a[:, :res].astype(int)
                                    - a[:, res:].astype(int)).max() > 0
                             for a in imgs),
    }
    emit({"phase": "clis", "seconds": secs,
          "launches": {k: v["launches"] for k, v in paths.items()
                       if k.startswith("cli_")},
          "max_abs_s_diff": float(np.abs(s - ref).max()), "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"CLI checks failed: {checks}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "stylemc_torch")):
        print("chip_smoke: run it from a checkout of the repository "
              "(stylemc_torch/ not found)", file=sys.stderr)
        return 1

    smi = phase_env(torch)
    phase_build()
    kernel_rows = phase_kernel(torch)
    paths = {}  # path → its launches and synthesis calls
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        _, net, direction = make_network(torch, tmp)
        editor = phase_serve(torch, net, direction, smi, paths)
        phase_parity(editor, net, direction, paths)
        phase_clis(editor, net, direction, tmp, paths)

    chain = [r for r in kernel_rows if tuple(r["shape"]) in CHAIN_SHAPES]

    def chain_sum(key):
        return sum(r[key] for r in chain)

    print(smi, flush=True)
    emit({"kernels": [{
        "name": "upsample2x", "route": "cuda",
        "source": "stylemc_torch/ops/kernels/csrc/upsample2x.cu",
        "replaces": "stylemc_tpu/ops/pallas/upfirdn2d_pallas.py:132",
        "replaces_function": "_upsample2x_core",
        "launches": sum(p["launches"] for p in paths.values()),
        "launches_by_path": {k: v["launches"] for k, v in paths.items()},
        "max_abs_err": max(r["max_abs_err"] for r in kernel_rows),
        "ms": chain_sum("kernel_ms"), "kernel_ms": chain_sum("kernel_ms"),
        "plain_ms": chain_sum("plain_ms"), "bound_ms": chain_sum("bound_ms"),
        "bound_us": chain_sum("bound_ms") * 1e3,
        "bound_by": chain[0]["bound_by"],
        "library_ms": chain_sum("library_ms"),
        "wrapper_event_ms": chain_sum("wrapper_event_ms"),
        "times_are": "sum over the six ToRGB chain shapes at batch 16 "
                     "(one batch-16 FFHQ-256 synthesis call); *_ms device "
                     "time (CUDA events around calls queued behind a sleep "
                     "kernel); wrapper_event_ms CUDA events over "
                     "back-to-back wrapper calls (host cost included)",
        "card": smi}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
