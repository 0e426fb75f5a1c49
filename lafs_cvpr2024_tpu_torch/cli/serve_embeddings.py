"""Embedding SERVER on the GPU (counterpart of ``lafs_cvpr2024_tpu/cli/
serve_embeddings.py``): loads a Part-fViT ``.pth`` once, warms the model up
at a FIXED batch shape (partial batches are padded up), and serves requests
over a unix-domain socket in the JAX server's wire protocol, byte for byte:

  request:  header ``<u32 magic=0x4C414653> <u32 n> <u32 h> <u32 w>``
            followed by ``n*h*w*3`` bytes of uint8 RGB (pre-aligned crops)
  response: ``<u32 n> <u32 d>`` followed by ``n*d`` float32 embeddings
            (flip-fused + L2-normalised)
  error:    ``<u32 0xFFFFFFFF> <u32 len> <utf-8 message>``

JPEG ingestion (magic ``0x4C414A50``) is not ported yet: such a request is
read and answered with an error frame. Both packages' ``EmbeddingClient``
work against this server.

    python -m lafs_cvpr2024_tpu_torch.cli.serve_embeddings \\
        --checkpoint model.pth --socket /tmp/lafs.sock

The server runs on CUDA and refuses to start without it, unless
``--device cpu`` is given explicitly.

Spans (``utils/tracing.py``, when on), each with ``request=i``, the
request's place in the order the server read them: ``serve.read`` (from
its header to the parsed batch), ``serve.dispatch`` (pad, copy, launch),
``serve.collect.wait`` (the wait for the card), ``serve.collect.fetch``
(copy back, flip-sum, normalise) and ``serve.send``; counters
``serve.rows`` (rows forwarded, padding and flipped views included),
``serve.faces`` and ``serve.requests``.
"""

from __future__ import annotations

import argparse
import os
import select
import socket
import struct

import numpy as np
import torch

from ..eval.loading import (
    EVAL_DTYPES,
    add_arch_flags,
    add_input_scale_flag,
    arch_overrides_from_args,
    load_eval_model,
    resolve_input_scale,
)
from ..ops.augment_device import scale_uint8
from ..utils import tracing

MAGIC = 0x4C414653  # "LAFS": raw uint8 pixels
MAGIC_JPEG = 0x4C414A50  # "LAJP": JPEG crops + 5-pt landmarks (not ported)
ERR = 0xFFFFFFFF


def get_args(argv=None):
    p = argparse.ArgumentParser("lafs embedding server (PyTorch/CUDA)")
    p.add_argument("--checkpoint", required=True, help="Part-fViT .pth")
    p.add_argument("--socket", required=True, help="unix socket path")
    p.add_argument("--batch-size", type=int, default=256,
                   help="fixed batch shape; requests are padded up and "
                        "chunked down to it")
    p.add_argument("--eval-dtype", default="bfloat16",
                   choices=list(EVAL_DTYPES), help="forward compute dtype")
    p.add_argument("--no-flip", dest="flip", action="store_false",
                   default=True)
    p.add_argument("--max-requests", type=int, default=0,
                   help="exit after N connections (0 = run forever)")
    p.add_argument("--device", default="cuda",
                   help="torch device; the server requires CUDA unless "
                        "'cpu' is given explicitly")
    add_arch_flags(p)
    add_input_scale_flag(p)
    return p.parse_args(argv)


def _recv_exact(conn, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-message")
        buf.extend(chunk)
    return bytes(buf)


class _InFlight(list):
    """The dispatched chunks of one request, ``(embeddings, faces)`` each,
    with the request's id and, when tracing, an event after each chunk's
    forward."""

    def __init__(self, request: int):
        super().__init__()
        self.request, self.events = request, []


class EmbeddingServer:
    """The model behind a fixed batch shape, on one device."""

    def __init__(self, args):
        self.device = torch.device(args.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "the embedding server needs a CUDA device; pass --device cpu "
                "to serve from the CPU deliberately"
            )
        self.args = args
        log = lambda m: print(f"[serve] {m}")  # noqa: E731
        loaded = load_eval_model(args.checkpoint, arch_overrides_from_args(args),
                                 device=self.device, log=log)
        args.input_scale = resolve_input_scale(args.input_scale, loaded.family,
                                               log=log)
        self.dtype = EVAL_DTYPES[args.eval_dtype]
        # Every float tensor of the model — BatchNorm running stats included —
        # is cast to the eval dtype, as the JAX server casts every float leaf
        # (serve_embeddings.py:118-120). In bf16 the landmark min-max rescale
        # therefore runs in bf16 too (a 0.5 px step near 111): mirrored, not
        # fixed.
        self.model = loaded.model.to(self.dtype)
        # warm up the fixed shape (kernel build, cuDNN plans) before traffic
        b = args.batch_size * (2 if args.flip else 1)
        warm = np.zeros((b, args.image_size, args.image_size, 3), np.uint8)
        self._embed(torch.from_numpy(warm).to(self.device)).cpu()
        print(f"[serve] warmed up batch {args.batch_size} "
              f"(flip={'on' if args.flip else 'off'}) on {self.device}")
        self.requests_read = 0  # request i is the i-th read

    @torch.inference_mode()
    def _embed(self, batch: torch.Tensor) -> torch.Tensor:
        x = scale_uint8(batch, self.args.input_scale).to(self.dtype)
        return self.model(x).float()

    def _dispatch(self, imgs: np.ndarray):
        """Chunk + pad and LAUNCH the device work without fetching results
        (CUDA runs asynchronously): opaque handles for ``_collect``."""
        bs = self.args.batch_size
        out = _InFlight(self.requests_read - 1)  # the request last read
        with tracing.span("serve.dispatch", request=out.request):
            for s in range(0, len(imgs), bs):
                chunk = imgs[s:s + bs]
                n = len(chunk)
                if n < bs:  # pad up to the fixed shape
                    chunk = np.concatenate(
                        [chunk, np.zeros((bs - n, *chunk.shape[1:]),
                                         np.uint8)])
                batch = torch.from_numpy(chunk.copy()).to(
                    self.device, non_blocking=True)
                if self.args.flip:
                    batch = torch.cat([batch, torch.flip(batch, dims=[2])])
                out.append((self._embed(batch), n))
                if tracing.ON:
                    tracing.count("serve.rows", len(batch))
                    if self.device.type == "cuda":
                        out.events.append(torch.cuda.Event())
                        out.events[-1].record()
        if tracing.ON:
            tracing.count("serve.faces", len(imgs))
            tracing.count("serve.requests")
        return out

    def _collect(self, handles) -> np.ndarray:
        """Fetch dispatched device work → L2-normalised (N, D) float32;
        when tracing, the wait for the card and the fetch are timed
        apart."""
        if not tracing.ON:
            return self._fetch(handles)
        with tracing.span("serve.collect.wait", request=handles.request):
            for event in handles.events:
                event.synchronize()
        with tracing.span("serve.collect.fetch", request=handles.request):
            return self._fetch(handles)

    def _fetch(self, handles) -> np.ndarray:
        bs = self.args.batch_size
        out = []
        for dev, n in handles:
            emb = dev.cpu().numpy()
            if self.args.flip:
                emb = emb[:bs] + emb[bs:]
            out.append(emb[:n])
        e = np.concatenate(out)
        return e / np.maximum(np.linalg.norm(e, axis=1, keepdims=True), 1e-12)

    def embed(self, imgs: np.ndarray) -> np.ndarray:
        """uint8 (N, S, S, 3) → L2-normalised float32 (N, D); any N."""
        return self._collect(self._dispatch(imgs))

    def _read_request(self, conn):
        """Parse ONE request into a uint8 batch. None on a clean peer close
        before any header byte; raises ValueError on protocol faults."""
        try:
            hdr = _recv_exact(conn, 8)
        except ConnectionError:
            return None
        self.requests_read += 1
        with tracing.span("serve.read", request=self.requests_read - 1):
            return self._parse_request(conn, hdr)

    def _parse_request(self, conn, hdr: bytes):
        size = self.args.image_size
        magic, n = struct.unpack("<II", hdr)
        if not 0 < n <= 65536:
            raise ValueError(f"bad batch size {n}")
        if magic == MAGIC:
            h, w = struct.unpack("<II", _recv_exact(conn, 8))
            if h != size or w != size:
                raise ValueError(f"expected {size}x{size} images, got {h}x{w}")
            raw = _recv_exact(conn, n * h * w * 3)
            return np.frombuffer(raw, np.uint8).reshape(n, h, w, 3)
        if magic == MAGIC_JPEG:
            # consume the request so the client reads the error frame
            (total,) = struct.unpack("<I", _recv_exact(conn, 4))
            _recv_exact(conn, 44 * n + total)
            raise ValueError(
                "JPEG ingestion (magic 0x4C414A50) is not yet ported to the "
                "PyTorch server; send aligned uint8 crops (magic 0x4C414653)"
            )
        raise ValueError(f"bad magic 0x{magic:08x}")

    def handle(self, conn) -> None:
        """Serve one connection (many requests) until the peer closes.
        Responses return in request order; the device work of request i
        overlaps the parse of request i+1 when the client pipelines."""

        def _send(emb, request):
            with tracing.span("serve.send", request=request):
                conn.sendall(struct.pack("<II", *emb.shape) + emb.tobytes())

        pending = None  # dispatched-but-unfetched device work
        while True:
            nxt, err = False, None
            try:
                if pending is None:
                    nxt = self._read_request(conn)
                elif select.select([conn], [], [], 0)[0]:
                    nxt = self._read_request(conn)
            except ValueError as e:  # request-level faults the client hears
                err = e
            if pending is not None:
                emb = self._collect(pending)
                request, pending = pending.request, None
                try:
                    _send(emb, request)
                except OSError:
                    return
            if err is not None:
                msg = str(err).encode()
                try:
                    conn.sendall(struct.pack("<II", ERR, len(msg)) + msg)
                except OSError:
                    pass
                return
            if nxt is None:
                return
            if nxt is not False:
                pending = self._dispatch(nxt)


class EmbeddingClient:
    """Minimal client for the raw-pixel protocol above."""

    def __init__(self, path: str):
        self._path = path

    @staticmethod
    def _read_response(s) -> np.ndarray:
        a, b = struct.unpack("<II", _recv_exact(s, 8))
        if a == ERR:
            raise RuntimeError(_recv_exact(s, b).decode())
        return np.frombuffer(_recv_exact(s, a * b * 4), np.float32).reshape(a, b)

    @staticmethod
    def _payload(imgs) -> bytes:
        imgs = np.ascontiguousarray(imgs, np.uint8)
        if imgs.ndim != 4 or imgs.shape[-1] != 3:
            raise ValueError(f"expected (n, h, w, 3) uint8, got {imgs.shape}")
        n, h, w, _ = imgs.shape
        return struct.pack("<IIII", MAGIC, n, h, w) + imgs.tobytes()

    def embed(self, imgs: np.ndarray) -> np.ndarray:
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
            s.connect(self._path)
            s.sendall(self._payload(imgs))
            return self._read_response(s)

    def embed_stream(self, items):
        """Stream many requests over ONE connection, one request in flight
        ahead of the reads; yields one (n, D) array per item, in order."""
        it = iter(items)
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
            s.connect(self._path)
            try:
                first = next(it)
            except StopIteration:
                return
            s.sendall(self._payload(first))
            for item in it:
                s.sendall(self._payload(item))
                yield self._read_response(s)
            yield self._read_response(s)


def serve(server: EmbeddingServer, path: str, max_requests: int = 0) -> None:
    """Accept connections on the unix socket ``path`` and serve them one at
    a time (the device is the serial resource); stop after
    ``max_requests`` connections when it is positive."""
    if os.path.exists(path):
        os.remove(path)
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        sock.bind(path)
        sock.listen(16)
        print(f"[serve] listening on {path}")
        served = 0
        while True:
            conn, _ = sock.accept()
            with conn:
                server.handle(conn)
            served += 1
            if max_requests and served >= max_requests:
                print(f"[serve] served {served} connections, exiting")
                return
    finally:
        sock.close()
        if os.path.exists(path):
            os.remove(path)


def main(argv=None):
    args = get_args(argv)
    serve(EmbeddingServer(args), args.socket, args.max_requests)


if __name__ == "__main__":
    main()
