"""The catalogue of kernel cases (`utils/kernel_cases.py`) on the CPU.

Every C entry point in `csrc/*.cu` that launches a kernel must have a case,
for each variant it accepts and each code layout it takes, so that a
kernel added without one fails here. Each case's plain half runs at its own
shapes (the wrappers take their plain versions for CPU tensors); the card
runs the kernel halves (`tests/test_torch_kernels_gpu.py`, chip_smoke.py).
"""

import ctypes
import os
import re
import sys

import pytest
import torch

from local_search_quantization_torch import _build, ivf
from local_search_quantization_torch.ops.select_kernels import lex_topk
from local_search_quantization_torch.utils import kernel_cases as kc

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "local_search_quantization_torch", "csrc")
_KEYWORDS = {"if", "for", "while", "switch", "return", "sizeof", "static_cast"}


def _body(src: str, brace: int) -> str:
    """The text between the brace at `brace` and its match."""
    depth = 0
    for i in range(brace, len(src)):
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        if depth == 0:
            return src[brace + 1:i]
    raise ValueError("unbalanced braces")


def _functions(src: str) -> dict[str, str]:
    """{name: the bodies of every definition of that name}, templates and
    overloads joined."""
    out: dict[str, str] = {}
    for m in re.finditer(r"\b(\w+)\s*(?:<[^;{}()]*>)?\s*\(([^;{}]*)\)\s*(?:const\s*)?\{", src):
        if m.group(1) not in _KEYWORDS:
            out[m.group(1)] = out.get(m.group(1), "") + _body(src, m.end() - 1)
    return out


def _launching_entries() -> dict[str, dict[str, set[int]]]:
    """{C entry point: {switch parameter: the values it accepts}} for every
    function of an `extern "C"` block in csrc/*.cu that reaches a `<<<...>>>`
    launch, directly or through the file's other functions. The parameters
    are the `switch`es of its body (cases written out or made by a macro)
    and its tests of `code_bytes`/`elem_bytes`."""
    entries = {}
    for name in sorted(os.listdir(_CSRC)):
        if not name.endswith(".cu"):
            continue
        with open(os.path.join(_CSRC, name)) as f:
            src = re.sub(r"//[^\n]*", "", f.read())
        funcs = _functions(src)
        launching = {f for f, body in funcs.items() if "<<<" in body}
        grew = True
        while grew:
            new = {f for f, body in funcs.items() if f not in launching and any(
                re.search(rf"\b{g}\s*(<[^;()]*>)?\s*\(", body) for g in launching)}
            launching |= new
            grew = bool(new)
        block = src.index('extern "C" {')
        for fname, body in _functions(_body(src, block + len('extern "C" '))).items():
            if fname not in launching:
                continue
            params: dict[str, set[int]] = {}
            for sw in re.finditer(r"switch\s*\((\w+)\)\s*\{", body):
                sbody = _body(body, sw.end() - 1)
                vals = {int(v) for v in re.findall(r"\bcase\s+(\d+)\s*:", sbody)}
                for mac in re.finditer(r"#define\s+(\w+)\((\w+)[^)]*\)[^\n]*\\\n\s*case\s+(\w+)",
                                       body):
                    if mac.group(2) == mac.group(3):
                        vals |= {int(v) for v in re.findall(rf"\b{mac.group(1)}\((\d+)", sbody)}
                params[sw.group(1)] = vals
            for p in ("code_bytes", "elem_bytes"):
                vals = {int(v) for v in re.findall(rf"\b{p}\s*==\s*(\d+)", body)}
                if vals:
                    params[p] = vals
            entries[fname] = params
    return entries


def test_every_launching_entry_point_has_a_case_for_each_value_it_accepts():
    entries = _launching_entries()
    # The parse finds the entry points that launch, and only those.
    assert {"lsq_ils_encode", "lsq_icm_sweeps_v2", "lsq_icm_sweeps_v1",
            "lsq_icm_sweeps_dissect", "lsq_scan_topk", "lsq_k2_filter", "lsq_k2_select",
            "lsq_select_topk", "lsq_scan_key", "lsq_ivf_scan", "lsq_ivf_probes",
            "lsq_l2_gather"} == set(entries)
    assert entries["lsq_icm_sweeps_dissect"]["variant"] == {0, 1, 2, 3, 4}
    assert entries["lsq_scan_key"]["code_bytes"] == {1, 4}
    assert entries["lsq_ivf_scan"]["kcap"] == {32, 256, 2048}
    for entry, params in entries.items():
        cases = [c for c in kc.CASES if entry in c.entries]
        assert cases, f"{entry} has no case"
        for param, values in params.items():
            covered = {c.params.get(param) for c in cases}
            assert values <= covered, f"{entry}: {param} {values - covered} has no case"
    names = [c.name for c in kc.CASES]
    assert len(set(names)) == len(names)


_CTYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "unsigned": ctypes.c_uint,
           "void*": ctypes.c_void_p, "const void*": ctypes.c_void_p}


@pytest.mark.parametrize("source", _build.KERNELS)
def test_build_binds_every_entry_point_of_a_source_as_it_is_declared(source):
    """`_build.ENTRIES` holds every function of the source's `extern "C"`
    block (but `lsq_error_string`, which `Library` binds itself) with the
    C types of its parameters and result; the entries that launch return a
    checked cudaError_t (restype None there)."""
    with open(os.path.join(_CSRC, source + ".cu")) as f:
        src = re.sub(r"//[^\n]*", "", f.read())
    block = src.index('extern "C" {')
    declared = {}
    for m in re.finditer(r"^(int|long long|const char\*)\s+(lsq_\w+)\(([^)]*)\)",
                         _body(src, block + len('extern "C" ')), re.M):
        params = [re.sub(r"\s*\w+$", "", a.strip()) for a in m.group(3).split(",") if a.strip()]
        declared[m.group(2)] = ([_CTYPES[p.replace(" *", "*")] for p in params], m.group(1))
    assert declared.pop("lsq_error_string")[1] == "const char*"
    launching = _launching_entries()
    bound = _build.ENTRIES[source]
    assert set(bound) == set(declared)
    for entry, (argtypes, restype) in bound.items():
        want_args, want_ret = declared[entry]
        assert argtypes == list(want_args), entry
        if entry in launching:
            assert restype is None and want_ret == "int", entry
        else:
            assert restype == _CTYPES[want_ret], entry


@pytest.mark.parametrize("case", kc.CASES, ids=[c.name for c in kc.CASES])
def test_case_plain_half_runs_on_the_cpu(case):
    """On CPU tensors the wrapper takes its plain version: the case passes
    and launches nothing."""
    bad, launched = kc.run_case(case, torch.device("cpu"))
    assert bad is None and launched == 0


def test_catalogue_command_line_on_the_cpu(capsys):
    try:
        assert kc.main(["--device", "cpu", "--only", "K2 select", "--fill", "nan"]) == 0
    finally:
        torch.use_deterministic_algorithms(False)
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == ("kernel_cases: all 3 cases passed on cpu (0 kernel launches, "
                       "fill nan)")


def test_catalogue_asks_for_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kc.main(["--only", "K2 select"])


def test_sanitizer_filter_names_every_kernel_in_csrc():
    """The sanitizer checks the kernels whose mangled names hold one of
    `SANITIZED_KERNELS`: every `__global__` function in csrc/ is one of
    them, and each name matches a kernel."""
    kernels = set()
    for name in os.listdir(_CSRC):
        if name.endswith(".cu"):
            with open(os.path.join(_CSRC, name)) as f:
                kernels |= set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\(.*\)\s+)?"
                                          r"(\w+)\s*\(", f.read()))
    assert len(kernels) == 16
    assert kernels == set(kc.SANITIZED_KERNELS)


def test_sanitizer_is_found_as_nvcc_is_and_its_command_runs_the_cases(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path / "nowhere"))
    assert _build.sanitizer() is None
    with pytest.raises(RuntimeError, match="compute-sanitizer not found in .*bin"):
        kc.sanitizer_command("memcheck")
    tool = tmp_path / "compute-sanitizer" / "compute-sanitizer"
    tool.parent.mkdir()
    tool.write_text("")
    assert _build.sanitizer() == str(tool)
    (tmp_path / "bin").mkdir()
    (tmp_path / "bin" / "compute-sanitizer").write_text("")
    assert _build.sanitizer() == str(tmp_path / "bin" / "compute-sanitizer")
    cmd = kc.sanitizer_command("racecheck")
    assert cmd[:3] == [_build.sanitizer(), "--tool", "racecheck"]
    assert cmd[-5:] == [sys.executable, "-m", kc.__name__, "--device", "cuda"]
    assert [cmd[i + 1] for i, a in enumerate(cmd) if a == "--kernel-name"] == [
        f"kns={k}" for k in kc.SANITIZED_KERNELS]


# Mutants of the coarse probes that the catalogue's comparison must flag:
# the norm term dropped, exact ties to the higher id, the lists of one chunk
# (`ivf.ivf_probe_plan`'s first, on a card of 132 SMs) left out. Each case is
# one the kernel serves.
def _probes_no_norm(a, nprobe):
    Q, CT, cn = a
    return ivf.coarse_probes_reference(Q, CT, torch.zeros_like(cn), nprobe)


def _probes_ties_reversed(a, nprobe):
    Q, CT, cn = a
    nlist = cn.shape[0]
    rev = (nlist - 1 - torch.arange(nlist)).expand(Q.shape[0], nlist)
    ids = lex_topk(cn[None, :] - 2.0 * (Q @ CT), rev, nprobe)[1]
    return torch.where(ids >= 0, nlist - 1 - ids, -1)


def _probes_chunk_left_out(a, nprobe):
    Q, CT, cn = a
    nlist = cn.shape[0]
    chunks = ivf.ivf_probe_plan(Q.shape[0], nlist, 132)
    tiles = -(-nlist // ivf._PROBES_CTILE)
    cn = cn.clone()
    cn[:tiles // chunks * ivf._PROBES_CTILE] = float("inf")
    return ivf.coarse_probes_reference(Q, CT, cn, nprobe)


@pytest.mark.parametrize("mutant", [_probes_no_norm, _probes_ties_reversed,
                                    _probes_chunk_left_out])
@pytest.mark.parametrize("label", ["nq=1000 nlist=1024 d=128 nprobe=64, integer",
                                   "nq=7 nlist=16384 d=128 nprobe=64, duplicated lists"])
def test_coarse_probes_cases_flag_mutants(mutant, label):
    case = next(c for c in kc.CASES if c.name == f"IVF probes {label}")
    nprobe = int(label.split("nprobe=")[1].split(",")[0])
    inputs = case.make(torch.device("cpu"))
    want = case.plain(inputs)
    assert case.compare(want.clone(), want, inputs) is None
    assert case.compare(mutant(inputs, nprobe), want, inputs) is not None
