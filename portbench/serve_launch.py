"""Start the port's serve twin (`scripts.serve.main`) for the served cells, and
report its peak device memory; with `--trace-out`, trace its window.

    python3 -m portbench.serve_launch --report R.json [--trace-out T.json] -- <serve args>

The server runs as `python -m local_search_quantization_torch.scripts.serve
<serve args>` does: its protocol on stdin and stdout, its notes on stderr.
With `--trace-out`, the line `TRACE_START` on stdin starts `torch.profiler`
(CPU and CUDA activity) and opens the window's annotation, `TRACE_STOP`
closes both and writes the Chrome trace to the path; neither line reaches
the server, and each is acknowledged by a JSON line on stdout
(`{"portbench_trace": "started"}`, `... "stopped"`). At exit the report
file gets `{"memory_peak_bytes": ..., "trace": path or null}`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TRACE_START, TRACE_STOP = b"TRACE_START", b"TRACE_STOP"


class _MarkedStdin:
    """The server's stdin with the trace marks taken out of its lines."""

    def __init__(self, raw, marks: dict):
        self.buffer = self
        self._raw, self._marks = raw, marks

    def readline(self, *args):
        while True:
            line = self._raw.readline(*args)
            act = self._marks.get(line.strip())
            if act is None:
                return line
            act()

    def read(self, *args):
        return self._raw.read(*args)


class _WindowTrace:
    def __init__(self, path: str):
        self.path, self.written = path, False
        self.prof = self.span = None

    def _ack(self, what: str) -> None:
        sys.stdout.buffer.write(json.dumps({"portbench_trace": what}).encode() + b"\n")
        sys.stdout.buffer.flush()

    def start(self) -> None:
        import torch

        from portbench.trace import WINDOW

        self.prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
        self.prof.start()
        self.span = torch.profiler.record_function(WINDOW)
        self.span.__enter__()
        self._ack("started")

    def stop(self) -> None:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.span.__exit__(None, None, None)
        self.prof.stop()
        self.prof.export_chrome_trace(self.path)
        self.written = True
        self._ack("stopped")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" not in argv:
        raise SystemExit("serve_launch: give the server's arguments after --")
    cut = argv.index("--")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", required=True)
    ap.add_argument("--trace-out")
    args = ap.parse_args(argv[:cut])
    import torch

    from local_search_quantization_torch.scripts import serve

    window = None
    if args.trace_out:
        window = _WindowTrace(args.trace_out)
        sys.stdin = _MarkedStdin(sys.stdin.buffer, {TRACE_START: window.start,
                                                     TRACE_STOP: window.stop})
    try:
        serve.main(argv[cut + 1:])
    finally:
        peak = int(torch.cuda.max_memory_allocated()) if torch.cuda.is_available() else 0
        with open(args.report, "w") as f:
            json.dump({"memory_peak_bytes": peak,
                       "trace": args.trace_out if window and window.written else None}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
