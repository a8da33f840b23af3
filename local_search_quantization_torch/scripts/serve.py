#!/usr/bin/env python
"""Serve k-NN queries over an index directory on the GPU: the twin of
`scripts/serve.py`, speaking its protocol byte for byte.

    python -m local_search_quantization_torch.scripts.serve --index ./index_lsq [--device cpu]

JSON lines on stdin/stdout. The first output line announces readiness, after
the warm-up (on a GPU: the build of the kernels a request can launch, K1 for
`add` and K2-K4 for queries, at first use, then one search at the default
precision, so no request pays for nvcc):

    {"ready": true, "method": "lsq", "n": 1000000, "d": 128, "k": 100,
     "ivf_nlist": null, "refine": null}

then one response per request line:

    query:    {"id": 7, "vectors": [[...d floats...], ...], "k": 100}
           -> {"id": 7, "ids": [[...k ints...], ...], "dists": [[...], ...]}
              "dists": false omits the distances. "nprobe": p scans the p
              nearest IVF lists (needs a partition), "refine": r re-ranks the
              top r*k candidates by exact distance (needs a refine store),
              "precision": "bf16" rounds the LUTs once (exhaustive scans);
              --k, --nprobe, --refine and --precision set the defaults.
              Binary frames: "binary_vectors": N instead of "vectors", the
              line followed by N*d little-endian f32 bytes (row-major);
              "binary": true answers with the header line
                  {"id": 7, "nq": N, "k": K,
                   "binary": {"ids": "<i4", "dists": "<f4"|null}}
              followed by N*K*4 bytes of <i4 ids, then (unless "dists":
              false) N*K*4 bytes of <f4 distances. "add" takes frames too.
    insert:   {"op": "add", "id": 8, "vectors": [[...], ...]}
           -> {"id": 8, "added": [n0, n0+1, ...], "n": new_total}
    delete:   {"op": "delete", "id": 9, "ids": [3, 17]}
           -> {"id": 9, "deleted": 2, "n": total}   (tombstones; ids stable)
    compact:  {"op": "compact", "id": 11} -> {"id": 11, "removed": r, "n": new_total}
    persist:  {"op": "save", "id": 10} -> {"id": 10, "saved": ..., "n": ...}
    errors:   {"id": 7, "error": "<Type>: <message>"}

A line that does not parse answers with "id": null. Blank lines are
ignored; "EOF" or the end of stdin stops the server. Two faults end it with
exit code 1: a "binary_vectors" count that is not a non-negative int (the
frame's length is unknowable) and a truncated frame. A well-formed count
above the 512 MB cap has its frame drained (with a note on stderr first)
and is answered as an error.

`--mesh N` serves over an N-device data mesh (`Index.search(mesh=...)`: each
shard's top-k merged, the sharded codes cached across requests): the first N
CUDA devices, or N "cpu" entries with `--device cpu`; fewer than N cards, or a
nonzero `--nprobe` default with it, exits before "ready" (a per-request
nprobe answers as an error in mesh mode).

Beside the reference: `--device cuda|cpu` replaces `--platform`; stderr names
the device and the kernels the warm-up loaded and, at the end of the stream,
the kernel launches the requests made (`ops/launch_counts`; all 0 on the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# Run as a file from any directory: the repo root goes ahead of this folder.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from local_search_quantization_torch import _build  # noqa: E402
from local_search_quantization_torch.index import Index  # noqa: E402
from local_search_quantization_torch.ops import launch_counts  # noqa: E402
from local_search_quantization_torch.parallel.mesh import data_mesh  # noqa: E402
from local_search_quantization_torch.utils.device import entry_device  # noqa: E402

# Per-request payload cap for binary frames, in bytes: over-cap but
# well-formed requests have their frame drained and are answered as errors.
_MAX_BINARY_BYTES = 512 << 20
# The kernels a request can launch: K1 (add on an LSQ index), K2, K3, K4,
# and the IVF probed scan (nprobe).
WARM_KERNELS = ("ils_encode", "scan_topk", "scan_select", "scan_key", "ivf_scan")
# The stderr note at the end of the stream: the requests' kernel launches.
LAUNCHES_NOTE = "serve: kernel launches "


def _note(msg: str) -> None:
    print(f"serve: {msg}", file=sys.stderr, flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--index", required=True,
                    help="index directory from build_index (either package)")
    ap.add_argument("--k", type=int, default=100,
                    help="default neighbors per query (request may override)")
    ap.add_argument("--nprobe", type=int, default=0,
                    help="default IVF probe count; 0 = exhaustive "
                         "(request may override; needs --ivf-nlist at build)")
    ap.add_argument("--refine", type=int, default=0,
                    help="default exact-rerank factor; 0 = off (request may "
                         "override; needs --refine at build)")
    ap.add_argument("--precision", default="f32", choices=("f32", "bf16"),
                    help="default scan precision (request may override; "
                         "exhaustive scans only)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; raises without a GPU, "
                         "so pass cpu to run on the CPU)")
    ap.add_argument("--mesh", type=int, default=0,
                    help="serve over an N-device data mesh of --device's type "
                         "(Index.search(mesh=...): per-shard select + merge, "
                         "sharded codes cached across requests); 0 = single-"
                         "device. Exhaustive scans only: nprobe requests are "
                         "answered as errors in mesh mode.")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the kernel build and the warm-up search")
    args = ap.parse_args(argv)
    if args.mesh < 0:
        raise SystemExit(f"--mesh must be >= 0, got {args.mesh}")
    if args.mesh and args.nprobe:
        # Fail fast: every default query would otherwise answer as an error
        # after a healthy-looking "ready" line.
        raise SystemExit("--mesh and a nonzero --nprobe default are incompatible "
                         "(per-request nprobe still answers as an error in mesh mode)")

    device = entry_device(args.device)
    mesh = None
    if args.mesh:
        have = torch.cuda.device_count() if device.type == "cuda" else args.mesh
        if have < args.mesh:
            raise SystemExit(f"--mesh {args.mesh} needs {args.mesh} devices, have {have} "
                             f"(pass --device cpu for a mesh of CPU entries)")
        mesh = data_mesh([torch.device("cuda", i) for i in range(args.mesh)]
                         if device.type == "cuda" else ["cpu"] * args.mesh)
    idx = Index.load(args.index, device=device)
    kernels = []
    if not args.no_warmup:
        if device.type == "cuda":
            kernels = list(_build.load_all(WARM_KERNELS))
        # Warm with the server's default precision, so the first request of
        # a bf16 server pays for nothing the warm-up could have done.
        idx.search(np.zeros((1, idx.d), np.float32), min(args.k, idx.n), mesh=mesh,
                   precision=args.precision)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    if mesh is not None:
        name += f", mesh of {len(mesh.devices)}: {', '.join(map(str, mesh.devices))}"
    _note(f"device {name}; kernels loaded by the warm-up: "
          f"{', '.join(kernels) if kernels else 'none'}")
    launch_counts.zero()  # from here on, the requests' launches only

    stdin = sys.stdin.buffer
    stdout = sys.stdout.buffer

    def emit(obj, blocks=()):
        stdout.write(json.dumps(obj).encode() + b"\n")
        for b in blocks:
            stdout.write(b)
        stdout.flush()

    def read_exact(nbytes: int) -> bytes:
        buf = stdin.read(nbytes)
        if buf is None or len(buf) != nbytes:
            raise EOFError(f"binary payload truncated "
                           f"({0 if buf is None else len(buf)}/{nbytes} bytes)")
        return buf

    def parse_vectors(req, frame) -> np.ndarray:
        if frame is not None:
            # A copy: np.frombuffer's view of the bytes is read-only.
            return np.frombuffer(frame, "<f4").reshape(-1, idx.d).copy()
        return np.asarray(req["vectors"], np.float32)

    def host(t: torch.Tensor, dtype: str) -> np.ndarray:
        return np.ascontiguousarray(t.cpu().numpy().astype(dtype))

    emit({"ready": True, "method": idx.method, "n": idx.n, "d": idx.d,
          "k": args.k,
          "ivf_nlist": idx.ivf.nlist if idx.ivf else None,
          "refine": idx.refine.kind if idx.refine else None})

    while True:
        raw = stdin.readline()
        if not raw:
            break  # stream EOF
        line = raw.decode("utf-8", "replace").strip()
        if not line:
            continue  # stray blank line: ignore, don't shut down
        if line == "EOF":
            break
        req = None  # never attribute errors to the previous request's id
        blocks = ()
        try:
            req = json.loads(line)
            # Consume a declared binary frame before any validation can
            # raise, so a bad request never leaves unread payload behind.
            frame = None
            if req.get("binary_vectors") is not None:
                nb = req["binary_vectors"]
                if not isinstance(nb, int) or isinstance(nb, bool) or nb < 0:
                    emit({"id": req.get("id"),
                          "error": "ValueError: binary_vectors must be a "
                                   f"non-negative int, got {nb!r}; frame "
                                   "length unknowable — closing the stream"})
                    _note(f"fatal binary_vectors={nb!r} (unknowable frame length)")
                    sys.exit(1)
                nbytes = nb * idx.d * 4
                if nb == 0 or nbytes > _MAX_BINARY_BYTES:
                    if nbytes:
                        _note(f"draining {nbytes} bytes of a binary frame over the "
                              f"{_MAX_BINARY_BYTES >> 20} MB cap (request id "
                              f"{req.get('id')!r}); the request is answered as an error")
                    while nbytes > 0:  # drain: length IS computable
                        chunk = stdin.read(min(nbytes, 1 << 24))
                        if not chunk:
                            raise EOFError(f"binary payload truncated while "
                                           f"draining ({nbytes} bytes short)")
                        nbytes -= len(chunk)
                    raise ValueError(
                        f"binary_vectors={nb} out of range (1 to "
                        f"{_MAX_BINARY_BYTES // (idx.d * 4)} rows at "
                        f"d={idx.d}; {_MAX_BINARY_BYTES >> 20} MB cap)")
                frame = read_exact(nbytes)
            op = req.get("op", "query")
            if op == "delete":
                ndel = idx.delete(req["ids"])
                out = {"id": req.get("id"), "deleted": ndel, "n": idx.n}
            elif op == "compact":
                n0 = idx.n
                idx.compact()
                out = {"id": req.get("id"), "removed": n0 - idx.n, "n": idx.n}
            elif op == "save":
                path = idx.save(args.index)
                out = {"id": req.get("id"), "saved": path, "n": idx.n}
            elif op == "add":
                added = idx.add(parse_vectors(req, frame))
                out = {"id": req.get("id"), "added": added, "n": idx.n}
            elif op == "query":
                res = idx.search(parse_vectors(req, frame),
                                 int(req.get("k", args.k)), mesh=mesh,
                                 nprobe=int(req.get("nprobe", args.nprobe)) or None,
                                 refine=int(req.get("refine", args.refine)) or None,
                                 precision=str(req.get("precision", args.precision)))
                want_dists = bool(req.get("dists", True))
                ids = host(res.ids, "<i4")
                if req.get("binary", False):
                    out = {"id": req.get("id"), "nq": int(ids.shape[0]),
                           "k": int(ids.shape[1]),
                           "binary": {"ids": "<i4",
                                      "dists": "<f4" if want_dists else None}}
                    blocks = [ids.tobytes()]
                    if want_dists:
                        blocks.append(host(res.dists, "<f4").tobytes())
                else:
                    out = {"id": req.get("id"), "ids": ids.tolist()}
                    if want_dists:
                        out["dists"] = host(res.dists, "<f4").tolist()
            else:
                raise ValueError(f"unknown op {op!r}")
        except EOFError as e:
            # Truncated binary frame: the stream cannot resync. Exit loudly:
            # a 0 exit would read as a clean shutdown.
            _note(f"fatal {e}")
            sys.exit(1)
        except Exception as e:  # a malformed request must not kill the server
            rid = req.get("id") if isinstance(req, dict) else None
            out = {"id": rid, "error": f"{type(e).__name__}: {e}"}
            blocks = ()
        emit(out, blocks)
    print(LAUNCHES_NOTE + json.dumps(launch_counts.read()), file=sys.stderr, flush=True)


def served_launches(stderr: str) -> dict:
    """The launch counts a server wrote at the end of its stream, from its
    stderr text."""
    found = [line[len(LAUNCHES_NOTE):] for line in stderr.splitlines()
             if line.startswith(LAUNCHES_NOTE)]
    if len(found) != 1:
        raise ValueError(f"{len(found)} launch-count lines on the server's stderr")
    return json.loads(found[0])


if __name__ == "__main__":
    main()
