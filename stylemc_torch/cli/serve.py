"""HTTP serving for batch edits (stdlib only), over serve.BatchEditor.

One device owner: with --coalesce_ms > 0 the CoalescingDispatcher's worker
thread issues all device work and merges concurrent same-parameter requests
into one batched call; --coalesce_ms 0 serialises requests through a lock.

Endpoints:
  GET /healthz                  → 200 "ok"
  GET /edit?seeds=1-4&power=2.0[&pairs=1][&direction=NAME][&format=png]
                                → image grid (vertical stack) of edits
  POST /edit_image?power=2.0[&pairs=1][&direction=NAME][&format=png]
       body: one JPEG/PNG photo (at most 32 MB), resized bicubic to 256²
                                → its e4e inversion, edited and rendered
                                  (needs --e4e_ckpt; 400 without)
  GET /directions               → JSON list of named directions
  GET /stats                    → JSON request counters + latency summary

Usage:
  python -m stylemc_torch.cli.serve --network ffhq.npz \
      --direction runs/m2f/direction_x.npz --port 8080
  python -m stylemc_torch.cli.serve --network decoder.pt \
      --direction runs/m2f/direction_x.npz --e4e_ckpt e4e_ffhq_encode.pt
  python -m stylemc_torch.cli.serve --network ffhq.npz \
      --mapper out/mapper_a_smiling_face.pth
"""

from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import click
import numpy as np


MAX_BODY_BYTES = 32 * 1024 * 1024


def _parse_seeds(spec: str):
    out = []
    for part in spec.split(","):
        if "-" in part:
            lo, hi = part.split("-")
            out.extend(range(int(lo), int(hi) + 1))
        else:
            out.append(int(part))
    return out


class EditService:
    """Thread-safe wrapper: device ownership + latency stats."""

    def __init__(self, editor, coalesce_ms: float = 0.0,
                 max_batch: int = 64):
        self.editor = editor
        self._lock = threading.Lock()
        self._dispatcher = None
        if coalesce_ms > 0:
            from ..serve import CoalescingDispatcher
            self._dispatcher = CoalescingDispatcher(
                max_batch=max_batch, max_wait_ms=coalesce_ms)
        self._latencies = []
        self.requests = 0
        self.errors = 0

    def _timed(self, fn) -> np.ndarray:
        t0 = time.perf_counter()
        if self._dispatcher is None:
            with self._lock:  # single device owner
                out = fn()
        else:
            out = fn()  # the dispatcher's worker owns the device
        with self._lock:
            self._latencies.append(time.perf_counter() - t0)
            self.requests += 1
        return out

    def edit(self, seeds, power: float, pairs: bool,
             direction_name=None) -> np.ndarray:
        if self._dispatcher is not None:
            return self._timed(lambda: self._dispatcher.submit(
                ("seeds", power, pairs, direction_name),
                np.asarray(seeds, np.int64),
                lambda arr: self.editor.edit_seeds(
                    [int(s) for s in arr], change_power=power, pairs=pairs,
                    direction_name=direction_name)))
        return self._timed(lambda: self.editor.edit_seeds(
            seeds, change_power=power, pairs=pairs,
            direction_name=direction_name))

    def edit_images(self, imgs_u8: np.ndarray, power: float, pairs: bool,
                    direction_name=None) -> np.ndarray:
        if self._dispatcher is not None:
            return self._timed(lambda: self._dispatcher.submit(
                ("image", power, pairs, direction_name),
                np.asarray(imgs_u8),
                lambda batch: self.editor.edit_images(
                    batch, change_power=power, pairs=pairs,
                    direction_name=direction_name)))
        return self._timed(lambda: self.editor.edit_images(
            imgs_u8, change_power=power, pairs=pairs,
            direction_name=direction_name))

    def record_error(self) -> None:
        with self._lock:
            self.errors += 1

    def stats(self):
        with self._lock:
            lat = np.asarray(self._latencies[-1000:]) * 1e3
            out = {"requests": self.requests, "errors": self.errors}
        if self._dispatcher is not None:
            out.update(batched_calls=self._dispatcher.batched_calls,
                       coalesced_items=self._dispatcher.coalesced_items)
        if lat.size:
            out.update(p50_ms=round(float(np.percentile(lat, 50)), 2),
                       p99_ms=round(float(np.percentile(lat, 99)), 2))
        return out

    def close(self) -> None:
        if self._dispatcher is not None:
            self._dispatcher.close()


def _edit_query(q):
    """/edit and /edit_image params → (power, pairs, fmt, direction
    name)."""
    return (float(q.get("power", ["2.0"])[0]),
            q.get("pairs", ["0"])[0] not in ("0", "false"),
            q.get("format", ["jpeg"])[0].lower(),
            q.get("direction", [None])[0])


def make_handler(service: EditService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _send(self, code, body: bytes, ctype="text/plain"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_image(self, arr, fmt: str):
            from PIL import Image
            buf = io.BytesIO()
            Image.fromarray(arr, "RGB").save(
                buf, format="PNG" if fmt == "png" else "JPEG")
            self._send(200, buf.getvalue(), f"image/{fmt}")

        def do_GET(self):
            url = urlparse(self.path)
            try:
                if url.path == "/healthz":
                    self._send(200, b"ok")
                elif url.path == "/directions":
                    self._send(200, json.dumps(
                        sorted(service.editor.directions)).encode(),
                        "application/json")
                elif url.path == "/stats":
                    self._send(200, json.dumps(service.stats()).encode(),
                               "application/json")
                elif url.path == "/edit":
                    q = parse_qs(url.query)
                    seeds = _parse_seeds(q.get("seeds", ["0"])[0])
                    if len(seeds) > 256:
                        self._send(400, b"too many seeds (max 256)")
                        return
                    power, pairs, fmt, dname = _edit_query(q)
                    imgs = service.edit(seeds, power, pairs,
                                        direction_name=dname)
                    self._send_image(np.concatenate(list(imgs), axis=0), fmt)
                else:
                    self._send(404, b"not found")
            except Exception as e:  # noqa: BLE001 — serving must not die
                service.record_error()
                self._send(500, f"error: {e}".encode())

        def do_POST(self):
            url = urlparse(self.path)
            try:
                if url.path != "/edit_image":
                    self._send(404, b"not found")
                    return
                if not service.editor.has_inverter:
                    self._send(400, b"no e4e inverter loaded (--e4e_ckpt)")
                    return
                length = int(self.headers.get("Content-Length", "0"))
                if not 0 < length <= MAX_BODY_BYTES:
                    self._send(400, b"need a JPEG/PNG body (max 32 MB)")
                    return
                from PIL import Image
                img = Image.open(io.BytesIO(
                    self.rfile.read(length))).convert("RGB")
                # the e4e eval transform's size; align faces beforehand
                img = img.resize((256, 256), Image.BICUBIC)
                power, pairs, fmt, dname = _edit_query(parse_qs(url.query))
                out = service.edit_images(
                    np.asarray(img, np.uint8)[None], power, pairs,
                    direction_name=dname)
                self._send_image(out[0], fmt)
            except Exception as e:  # noqa: BLE001 — serving must not die
                service.record_error()
                self._send(500, f"error: {e}".encode())

    return Handler


def build_server(editor, host: str = "127.0.0.1", port: int = 8080,
                 coalesce_ms: float = 0.0, max_batch: int = 64):
    service = EditService(editor, coalesce_ms=coalesce_ms,
                          max_batch=max_batch)
    server = ThreadingHTTPServer((host, port), make_handler(service))
    return server, service


@click.command()
@click.option("--network", required=True,
              help="NVIDIA .pkl, native .npz or rosinality .pt")
@click.option("--direction", type=str, default=None)
@click.option("--directions", type=str, multiple=True, metavar="NAME=PATH",
              help="named direction, repeatable; select per request via "
                   "/edit?direction=NAME")
@click.option("--mapper", type=str, default=None,
              help="mapper_{prompt}.pth: per-item directions from a latent "
                   "mapper when a request names no direction")
@click.option("--e4e_ckpt", type=str, default=None,
              help="e4e checkpoint: enables POST /edit_image (photo → "
                   "invert → edit → render in one request)")
@click.option("--host", type=str, default="127.0.0.1", show_default=True)
@click.option("--port", type=int, default=8080, show_default=True)
@click.option("--max_batch", type=int, default=64, show_default=True)
@click.option("--precision", default="fp32", show_default=True,
              type=click.Choice(["fp32", "bf16-upper", "bf16"]))
@click.option("--warmup/--no-warmup", default=True,
              help="render every batch bucket once before serving")
@click.option("--coalesce_ms", type=float, default=3.0, show_default=True,
              help="merge concurrent same-parameter requests arriving "
                   "within this window into one batched dispatch; 0 "
                   "disables (serial lock)")
@click.option("--data_parallel", is_flag=True, default=False,
              help="shard request batches over all local devices "
                   "(1-axis data mesh; buckets smaller than the mesh run "
                   "replicated)")
@click.option("--device", default="cuda", show_default=True)
def main(network, direction, directions, mapper, e4e_ckpt, host, port,
         max_batch, precision, warmup, coalesce_ms, data_parallel, device):
    from ..device import resolve_device
    from ..parallel.mesh import cli_mesh
    from ..serve import BatchEditor

    zoo = {}
    for entry in directions:
        name, _, path = entry.partition("=")
        if not path:
            raise click.BadParameter(f"expected NAME=PATH, got {entry!r}")
        zoo[name] = path
    device = resolve_device(device)
    mesh = cli_mesh(data_parallel, max_batch, device)
    if mesh is not None:
        print(f"data-parallel serving over {mesh.size} devices")
    editor = BatchEditor.from_files(network, direction=direction,
                                    mapper=mapper, directions=zoo or None,
                                    e4e_ckpt=e4e_ckpt, max_batch=max_batch,
                                    precision=precision, mesh=mesh,
                                    device=device)
    if warmup:
        print("warming up (every batch bucket)...")
        editor.warmup()
    server, _ = build_server(editor, host, port, coalesce_ms=coalesce_ms,
                             max_batch=max_batch)
    print(f"serving on http://{host}:{port}  (/edit?seeds=1-4&power=2.0)")
    server.serve_forever()


if __name__ == "__main__":
    main()
