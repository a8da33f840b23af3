"""Servable MCQ index: one frozen trained model + a mutable code store.

Port of `local_search_quantization_tpu.index` without a mesh:

    idx = Index.build(x_train, x_base, method="lsq", device="cuda")
    idx.save("./index_lsq")
    ...
    idx = Index.load("./index_lsq", device="cuda")
    res = idx.search(queries, k=100)   # CUDA select kernels, or the native
                                       # host scanner on the CPU
    idx.add(new_vectors)      # encode with the frozen model, append
    idx.delete([3, 17])       # O(1) +inf tombstones; ids stay stable
    idx.build_ivf(nlist=1024)             # coarse partition over the codes
    res = idx.search(queries, k=100, nprobe=32)   # scan 32 lists + the tail
    idx.save("./index_lsq")   # persist mutations atomically

The model tensors, the refine store and the scan cache (the codes uploaded
once, `adc.prepare_device_codes`) live on the index's device; the mutable
code store and the IVF partition stay in host memory, as in the JAX package
(a CUDA index uploads the partition's grouped store once for its probed
scans). An index directory written by either package loads in the other.
Search routing lives in `ops/adc.py` and `ivf.py`; this module owns the
lifecycle.
"""

from __future__ import annotations

import json
import os
import secrets
import sys

import numpy as np
import torch

from local_search_quantization_torch.ops import adc
from local_search_quantization_torch.utils import checkpoint as ckpt
from local_search_quantization_torch.utils.device import encode_in_chunks, entry_device

_METHODS = ("pq", "opq", "chainq", "lsq", "rvq")
_ENCODE_CHUNK = 1 << 16


def _scan_cache_enabled(n: int, device) -> bool:
    """Device-code scan cache gate: a CUDA index (the CPU route scans host
    memory through the native scanner) below the streaming segment bound
    (`adc.prepare_device_codes`)."""
    return torch.device(device).type == "cuda" and n <= (1 << 26)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _not_ported(what: str, module: str) -> NotImplementedError:
    """The error of a feature the port does not have yet; it names the module
    that brings it (ROADMAP.md, "Modules to port"), not a queue number, which
    changes as the roadmap is rewritten."""
    return NotImplementedError(f"{what} is not ported to the PyTorch package yet "
                               f"(module {module}; ROADMAP.md, modules to port)")


def _encode_chunked(fn, X, device) -> np.ndarray:
    """fn over `_ENCODE_CHUNK`-row pieces of X on `device`; host int32 codes."""
    return encode_in_chunks(fn, X, device, chunk=_ENCODE_CHUNK, host=True)


class Index:
    """A frozen quantizer model + mutable codes, searchable and persistable.

    Attributes:
      method: one of "pq", "opq", "chainq", "lsq", "rvq".
      model: the trained model NamedTuple, its tensors on `device`.
      B: [n, m] host codes (int32, or uint8 after load when h <= 256).
      meta: provenance dict (build args, bit budget).
      device: the torch device of the model, the refine store and the scans.
    """

    def __init__(self, method: str, model, B, *, bnorm=None, tomb=None,
                 meta: dict | None = None, device=None):
        if method not in _METHODS:
            raise ValueError(f"method must be one of {_METHODS}, got {method}")
        if device is None:
            device = next((v.device for v in model if isinstance(v, torch.Tensor)),
                          torch.device("cpu"))
        self.device = torch.device(device)
        self.method = method
        self.model = model._replace(**{
            f: v.to(self.device) for f, v in zip(model._fields, model)
            if isinstance(v, torch.Tensor)})
        self.refine = None  # optional exact-rerank store (attach_refine)
        self.ivf = None  # optional IVF coarse partition (build_ivf)
        self._ivf_cache = None  # (scan version, ivf.DeviceScan, tail state)
        self.meta = dict(meta or {})
        self.meta.setdefault("method", method)
        # Row storage is capacity-managed (amortized doubling on add): `_num`
        # rows of each `*_buf` are live; the public views slice to `_num`.
        B = _host(B)
        self._num = B.shape[0]
        self._B_buf = B
        self._tomb_buf = (np.zeros(self._num, bool) if tomb is None
                          else np.asarray(tomb, bool).copy())
        self._extra_buf = None  # pq/opq tombstone carrier, built lazily
        # Bumped on every mutation of the codes or the extra term, so the
        # uploaded scan state is never stale.
        self._scan_ver = 0
        self._scan_cache = None
        if self.additive:
            if bnorm is None:
                raise ValueError(f"{method} needs bnorm norm codes")
            self._cbnorms = (_host(self.model.cbnorms).astype(np.float32)
                             if method in ("lsq", "rvq") else self._meta_cbnorms())
            self._bnorm_buf = _host(bnorm)
            self._dbn_buf = self._cbnorms[self._bnorm_buf].astype(np.float32)
            self._dbn_buf[self._tomb_buf] = np.inf
        elif self._tomb_buf.any():
            self._extra_buf = np.where(self._tomb_buf, np.inf, 0.0).astype(np.float32)

    # Live-row views over the capacity buffers (writable: they are views).
    @property
    def B(self) -> np.ndarray:
        return self._B_buf[: self._num]

    @property
    def _tomb(self) -> np.ndarray:
        return self._tomb_buf[: self._num]

    @property
    def _bnorm(self) -> np.ndarray:
        return self._bnorm_buf[: self._num]

    @property
    def _dbn(self) -> np.ndarray:
        return self._dbn_buf[: self._num]

    @property
    def _extra(self) -> np.ndarray | None:
        e = self._extra_buf
        return None if e is None else e[: self._num]

    def _append_rows(self, B_new: np.ndarray, bnorm_new=None) -> int:
        """Amortized-O(1)-per-row append into the capacity buffers."""
        need = self._num + B_new.shape[0]
        cap = self._B_buf.shape[0]
        if need > cap:
            new_cap = max(need, 2 * cap)

            def grow(buf):
                out = np.empty((new_cap,) + buf.shape[1:], buf.dtype)
                out[:cap] = buf
                return out

            self._B_buf = grow(self._B_buf)
            self._tomb_buf = grow(self._tomb_buf)
            if self.additive:
                self._bnorm_buf = grow(self._bnorm_buf)
                self._dbn_buf = grow(self._dbn_buf)
            elif self._extra_buf is not None:
                self._extra_buf = grow(self._extra_buf)
        n0 = self._num
        self._B_buf[n0:need] = B_new.astype(self._B_buf.dtype)
        self._tomb_buf[n0:need] = False
        if self.additive:
            self._bnorm_buf[n0:need] = bnorm_new
            self._dbn_buf[n0:need] = self._cbnorms[bnorm_new]
        elif self._extra_buf is not None:
            self._extra_buf[n0:need] = 0.0
        self._num = need
        self._scan_ver += 1
        return n0

    # -- construction ------------------------------------------------------

    @classmethod
    def build(cls, x_train, x_base, method: str = "lsq", *, m: int | None = None,
              h: int = 256, niter: int = 10, ilsiter: int = 16, seed: int = 0,
              verbose: bool = False, refine: str | None = None, sr: str = "none",
              sr_scale: float = 1.0, meta: dict | None = None,
              device="cuda") -> "Index":
        """Train a quantizer on x_train and encode x_base, on `device` (the
        GPU unless device="cpu"; raises without a GPU otherwise).

        Defaults give 64-bit codes at h=256: m=8 for pq/opq, m=7 plus a
        1-byte norm code for the additive methods. refine: "sq8" / "f32"
        also keeps a copy of x_base for `search(refine=r)`. sr: LSQ's
        stochastic relaxation ("none" / "SR-D" / "SR-C"), lsq only. The LSQ
        base encode runs condition mode "auto" (K1 on a GPU).
        """
        from local_search_quantization_torch.models import (
            quantize_opq, quantize_pq, quantize_rvq, train_chainq, train_lsq, train_opq,
            train_pq, train_rvq,
        )
        from local_search_quantization_torch.ops import icm, norms, viterbi
        from local_search_quantization_torch.utils.config import (
            ChainQConfig, LSQConfig, OPQConfig, PQConfig, RVQConfig,
        )
        from local_search_quantization_torch.utils.synth import random_codes

        if method not in _METHODS:
            raise ValueError(f"method must be one of {_METHODS}, got {method}")
        if refine not in (None, "sq8", "f32"):
            raise ValueError(f"refine must be None, 'sq8' or 'f32', got {refine!r}")
        if sr not in ("none", "SR-D", "SR-C"):
            raise ValueError(f"sr must be none/SR-D/SR-C, got {sr!r}")
        if sr != "none" and method != "lsq":
            raise ValueError(
                f"sr={sr!r} is an LSQ training knob (LSQConfig.sr_method); "
                f"method={method!r} has no stochastic-relaxation stage")
        if sr_scale != 1.0 and sr == "none":
            raise ValueError(f"sr_scale={sr_scale} has no effect with sr='none': "
                             "pass sr='SR-C' or sr='SR-D'")
        device = entry_device(device)
        additive = method in ("chainq", "lsq", "rvq")
        if m is None:
            m = 7 if additive else 8
        x_train = np.asarray(x_train, np.float32)
        x_base = np.asarray(x_base, np.float32)
        X = torch.as_tensor(x_train).to(device)
        meta = dict(meta or {})
        bnorm = None
        if method == "pq":
            model = train_pq(X, PQConfig(m=m, h=h, kmeans_maxiter=max(25, niter),
                                         seed=seed))
            B = _encode_chunked(lambda x: quantize_pq(x, model.C_sub), x_base, device)
        elif method == "opq":
            model = train_opq(X, OPQConfig(m=m, h=h, niter=niter, seed=seed))
            B = _encode_chunked(lambda x: quantize_opq(x, model.R, model.C_sub),
                                x_base, device)
        elif method == "chainq":
            opq = train_opq(X, OPQConfig(m=m, h=h, niter=niter, seed=seed))
            model = train_chainq(X, opq.B, opq.R, ChainQConfig(m=m, h=h, niter=niter))
            B = _encode_chunked(lambda x: viterbi.viterbi_encode(x @ model.R, model.C),
                                x_base, device)
            cbn, _ = norms.train_norm_codebook(
                torch.as_tensor(B[:100_000]).to(device), model.C, h)
            # ChainQModel carries no norm codebook; it is stashed in meta.
            meta["cbnorms"] = _host(cbn).tolist()
            bnorm = _host(norms.quantize_norms(B, model.C, cbn))
        elif method == "rvq":
            model = train_rvq(X, RVQConfig(m=m, h=h, kmeans_maxiter=max(25, niter),
                                           seed=seed), verbose=verbose)
            B = _encode_chunked(lambda x: quantize_rvq(x, model.C), x_base, device)
            bnorm = _host(norms.quantize_norms(B, model.C, model.cbnorms))
        else:  # lsq
            opq = train_opq(X, OPQConfig(m=m, h=h, niter=niter, seed=seed))
            chain = train_chainq(X, opq.B, opq.R, ChainQConfig(m=m, h=h, niter=niter))
            cfg = LSQConfig(m=m, h=h, niter=niter, seed=seed, npert=min(4, m),
                            sr_method=sr, sr_scale=sr_scale)
            model = train_lsq(X, chain.B, chain.R, cfg, verbose=verbose)
            B0 = random_codes(seed, x_base.shape[0], m, h)
            gen = torch.Generator(device=device).manual_seed(seed + 1)
            enc = icm.encode_chunked(gen, x_base, B0, model.C, ilsiter=ilsiter,
                                     icmiter=cfg.icmiter, npert=cfg.npert,
                                     randord=cfg.randord)
            B = _host(enc.B).astype(np.int32)
            bnorm = _host(norms.quantize_norms(enc.B, model.C, model.cbnorms))
        full_meta = {
            "method": method, "m": m, "h": h, "d": int(x_train.shape[1]),
            "n": int(B.shape[0]), "ntrain": int(x_train.shape[0]),
            "bits": int(m * np.ceil(np.log2(h))) + (8 if additive else 0),
            "niter": niter, "seed": seed,
            "ilsiter": ilsiter if method == "lsq" else None,
        }
        if sr != "none":
            full_meta["sr"] = sr
            if sr_scale != 1.0:
                full_meta["sr_scale"] = sr_scale
        full_meta.update(meta)
        idx = cls(method, model, B, bnorm=bnorm, meta=full_meta, device=device)
        if refine:
            idx.attach_refine(x_base, kind=refine)
        return idx

    @classmethod
    def load(cls, path: str, device="cuda") -> "Index":
        """Load an index directory written by `save` of either package, onto
        `device` (the GPU unless device="cpu"; raises without a GPU
        otherwise).

        Codes at h <= 256 are kept as uint8 in host memory (the native
        scanner and the device layout both take bytes). An IVF partition
        (ivf.npz) or a refine store from another save than codes.npz (a crash
        between their renames) is dropped with a note on stderr.
        """
        from local_search_quantization_torch.refine import RefineStore

        device = entry_device(device)
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        model = ckpt.load_model(os.path.join(path, "model.npz"), device)
        codes = ckpt.load_codes(os.path.join(path, "codes.npz"))
        B = codes["B"]
        B = (np.ascontiguousarray(B, np.uint8) if meta["h"] <= 256
             else B.astype(np.int32, copy=False))
        if meta["method"] == "chainq" and "cbnorms" in codes:
            meta = dict(meta)
            meta["cbnorms"] = np.asarray(codes["cbnorms"]).tolist()
        idx = cls(meta["method"], model, B, bnorm=codes.get("bnorm"),
                  tomb=codes.get("tomb"), meta=meta, device=device)
        # codes.npz and the ivf/refine sidecars are replaced by separate
        # renames; one generation stamp per save() tells a crash leftover
        # apart. Pre-stamp saves fall back to the row-count checks. A kept
        # partition gets the tombstones re-applied (idempotent).
        gen = codes.get("gen")

        def sidecar_ok(side_gen, legacy_ok: bool, what: str) -> bool:
            if gen is None:
                return legacy_ok
            if side_gen is not None and bytes(side_gen) == bytes(gen):
                return True
            print(f"[index] dropping stale {what} from an interrupted save "
                  "(generation mismatch with codes.npz)", file=sys.stderr)
            return False

        ivf_path = os.path.join(path, "ivf.npz")
        if os.path.exists(ivf_path):
            from local_search_quantization_torch.ivf import IVFPartition

            with np.load(ivf_path) as z:
                arrs = dict(z)
            side_gen = arrs.pop("gen", None)
            part = IVFPartition.from_arrays(arrs)
            if sidecar_ok(side_gen, part.n_grouped <= idx.n, "IVF partition"):
                part.tombstone(np.flatnonzero(idx._tomb))
                idx.ivf = part
        rq_path = os.path.join(path, "refine.npz")
        if os.path.exists(rq_path):
            with np.load(rq_path) as z:
                arrs = dict(z)
            side_gen = arrs.pop("gen", None)
            rq = RefineStore.from_arrays(arrs, device=idx.device)
            if sidecar_ok(side_gen, rq.n == idx.n and rq.d == idx.d, "refine store"):
                idx.refine = rq
            else:
                idx.meta.pop("refine", None)
        idx._loaded_from = path  # lets save(path) skip the frozen model
        return idx

    def save(self, path: str) -> str:
        """Persist model + codes (+ norm codes, tombstones, IVF partition,
        refine store), every file of one save under one generation stamp.

        Codes and meta are written to a temporary file and renamed, so a
        crash cannot corrupt them; the frozen model is written only when
        absent. Codes are stored as int32, the canonical format.
        """
        os.makedirs(path, exist_ok=True)
        model_path = os.path.join(path, "model.npz")
        if not (os.path.exists(model_path)
                and getattr(self, "_loaded_from", None) == path):
            model_tmp = os.path.join(path, "model.tmp.npz")
            ckpt.save_model(model_tmp, self.model)
            os.replace(model_tmp, model_path)
        gen = np.bytes_(secrets.token_hex(16))
        extra_cols: dict = {"tomb": self._tomb, "gen": gen}
        if self.additive:
            extra_cols["bnorm"] = self._bnorm
            extra_cols["cbnorms"] = self._cbnorms
        tmp = os.path.join(path, "codes.tmp.npz")
        ckpt.save_codes(tmp, self.B.astype(np.int32, copy=False), extra_cols)
        out = os.path.join(path, "codes.npz")
        os.replace(tmp, out)
        ivf_path = os.path.join(path, "ivf.npz")
        if self.ivf is not None:
            ivf_tmp = os.path.join(path, "ivf.tmp.npz")
            np.savez(ivf_tmp, gen=gen, **self.ivf.to_arrays())
            os.replace(ivf_tmp, ivf_path)
        elif os.path.exists(ivf_path):
            os.remove(ivf_path)  # the partition was dropped
        rq_path = os.path.join(path, "refine.npz")
        if self.refine is not None:
            rq_tmp = os.path.join(path, "refine.tmp.npz")
            np.savez(rq_tmp, gen=gen, **self.refine.to_arrays())
            os.replace(rq_tmp, rq_path)
        elif os.path.exists(rq_path):
            os.remove(rq_path)
        meta = {k: v for k, v in self.meta.items() if k != "cbnorms"}
        meta["n"] = self.n
        meta_tmp = os.path.join(path, "meta.tmp.json")
        with open(meta_tmp, "w") as f:
            json.dump(meta, f, indent=2)
        os.replace(meta_tmp, os.path.join(path, "meta.json"))
        return out

    # -- properties --------------------------------------------------------

    @property
    def additive(self) -> bool:
        return self.method in ("chainq", "lsq", "rvq")

    @property
    def n(self) -> int:
        """Total rows including tombstoned ones (ids are stable)."""
        return int(self.B.shape[0])

    @property
    def active(self) -> int:
        return int(self.n - self._tomb.sum())

    @property
    def d(self) -> int:
        return int(self.meta["d"])

    def _meta_cbnorms(self) -> np.ndarray:
        """ChainQ's norm codebook lives beside the model, in meta."""
        cbn = self.meta.get("cbnorms")
        if cbn is None:
            raise ValueError("chainq index is missing its norm codebook")
        return np.asarray(cbn, np.float32)

    # -- operations ---------------------------------------------------------

    def _reconstructions(self) -> torch.Tensor:
        """[n, d] f32 code reconstructions in ORIGINAL space, on the index's
        device, a chunk of rows at a time. The IVF coarse quantizer partitions
        these (the ADC distance of a row is a function of its reconstruction
        only, see ivf.py). opq and chainq quantize in rotated space:
        xhat = recon @ R^T."""
        from local_search_quantization_torch.ops import costs
        from local_search_quantization_torch.ops.subspaces import reconstruct_pq

        model, d = self.model, self.d
        out = torch.empty((self.n, d), dtype=torch.float32, device=self.device)
        for s0 in range(0, self.n, _ENCODE_CHUNK):
            blk = torch.as_tensor(self.B[s0:s0 + _ENCODE_CHUNK]).to(self.device)
            rec = (costs.reconstruct(blk, model.C) if self.additive
                   else reconstruct_pq(blk, model.C_sub, d))
            if self.method in ("opq", "chainq"):
                rec = rec @ model.R.T
            out[s0:s0 + _ENCODE_CHUNK] = rec
        return out

    def build_ivf(self, nlist: int = 1024, *, sample: int = 1 << 18, iters: int = 25,
                  seed: int = 0) -> None:
        """Build (or rebuild) the IVF coarse partition over all current rows,
        on the index's device; afterwards search(..., nprobe=p) scans only the
        p nearest lists per query plus any rows added later (the exhaustive
        tail)."""
        from local_search_quantization_torch import ivf as ivf_mod

        extra = self._dbn if self.additive else self._extra
        self.ivf = ivf_mod.build_partition(
            self.B, self._reconstructions(), extra, nlist, seed=seed, sample=sample,
            iters=iters, device=self.device)
        self.meta["ivf_nlist"] = int(nlist)
        self._scan_ver += 1

    def attach_refine(self, X, kind: str = "sq8") -> None:
        """Keep a (scalar-quantized) copy of the original vectors, [n, d] in
        id order, on the index's device; afterwards search(refine=r)
        re-ranks the top r*k ADC candidates by exact distance."""
        from local_search_quantization_torch.refine import RefineStore

        X = torch.as_tensor(_host(X).astype(np.float32, copy=False))
        if tuple(X.shape) != (self.n, self.d):
            raise ValueError(f"refine vectors must be [{self.n}, {self.d}] in id "
                             f"order, got {tuple(X.shape)}")
        self.refine = RefineStore.build(X, kind, device=self.device)
        self.meta["refine"] = kind

    def _queries(self, Q) -> torch.Tensor:
        Q = torch.as_tensor(Q if isinstance(Q, torch.Tensor)
                            else np.asarray(Q, np.float32))
        return Q.to(self.device, torch.float32)

    def _query_luts(self, Q) -> torch.Tensor:
        """[nq, m, h] ADC tables with the exhaustive scans' semantics (L2 LUTs
        for pq/opq over rotated queries; -2<q,c> inner-product LUTs for the
        additive methods, norms carried separately)."""
        Q, model = self._queries(Q), self.model
        if self.additive:
            return adc.lsq_query_luts(Q @ model.R if self.method == "chainq" else Q,
                                      model.C)
        return adc.pq_query_luts(Q @ model.R if self.method == "opq" else Q,
                                 model.C_sub)

    def _device_scan_state(self):
        """The codes uploaded once to the index's device (serving hot path),
        keyed on `_scan_ver`, which every mutation bumps, so a stale upload
        never serves a query. CUDA only, below the segment bound."""
        if not _scan_cache_enabled(self.n, self.device):
            return None
        cached = self._scan_cache
        if cached is not None and cached[0] == self._scan_ver:
            return cached[1]
        extra = self._dbn if self.additive else self._extra
        state = adc.prepare_device_codes(self.B, extra, device=self.device,
                                         h=self.meta.get("h"))
        self._scan_cache = (self._scan_ver, state)
        return state

    def _tail_extra(self) -> np.ndarray | None:
        """The extra term of the rows added since the partition was built."""
        t0 = self.ivf.n_grouped
        if self.additive:
            return self._dbn[t0:]
        return None if self._extra is None else self._extra[t0:]

    def _ivf_device_state(self):
        """The partition's grouped store, and the tail's codes and extra
        term, uploaded once to a CUDA index's device and keyed on `_scan_ver`
        (every mutation of the codes, the tombstones or the partition bumps
        it)."""
        from local_search_quantization_torch import ivf as ivf_mod

        cached = self._ivf_cache
        if cached is not None and cached[0] == self._scan_ver:
            return cached[1], cached[2]
        scan = ivf_mod.DeviceScan(self.ivf, self.device)
        tail = None
        if self.n > self.ivf.n_grouped:
            tail = adc.prepare_device_codes(
                self.B[self.ivf.n_grouped:], self._tail_extra(), base_block=1,
                device=self.device, h=self.meta.get("h"))
        self._ivf_cache = (self._scan_ver, scan, tail)
        return scan, tail

    def _search_ivf(self, Q: torch.Tensor, k: int, nprobe: int) -> adc.KNNResult:
        """The probed scan, then the rows added since the partition was built
        scanned exhaustively and merged. A CUDA index scans on its device
        (`ivf.DeviceScan`; the tail through K2); a CPU index takes the native
        scanner where it is built, else the numpy oracle. ids are int64."""
        from local_search_quantization_torch import ivf as ivf_mod
        from local_search_quantization_torch.ops.select_kernels import scan_topk

        part = self.ivf
        luts = self._query_luts(Q).contiguous()
        t0 = part.n_grouped
        ntail = self.n - t0
        if self.device.type == "cuda":
            scan, tail = self._ivf_device_state()
            res = scan.search(luts, k, scan.probes(Q, nprobe))
            if ntail == 0:
                return res
            d, i = scan_topk(luts, *tail, min(k, ntail))
            tail_res = adc.KNNResult(d, torch.where(i >= 0, i.long() + t0, -1))
            return ivf_mod.merge_knn_device(res, tail_res, k)
        Qn, ln = Q.numpy(), luts.numpy()
        res = ivf_mod.search(part, ln, k, ivf_mod.coarse_probes(Qn, part, nprobe))
        if ntail:
            # The tail reuses the grouped scan's LUTs: they already carry the
            # method's rotation and norm semantics.
            tail = ivf_mod.exhaustive_scan(ln, self.B[t0:], self._tail_extra(),
                                           min(k, ntail))
            tail = adc.KNNResult(tail.dists,
                                 np.where(tail.ids >= 0, tail.ids + t0, tail.ids))
            res = ivf_mod.merge_knn(res, tail, k)
        return adc.KNNResult(torch.as_tensor(res.dists), torch.as_tensor(res.ids))

    def search(self, Q, k: int = 100, *, mesh=None, nprobe: int | None = None,
               refine: int | None = None, precision: str = "f32") -> adc.KNNResult:
        """ADC k-NN over every live row. Beyond `active` rows, results pad
        with the (+inf, -1) sentinel. Tensors on the index's device.

        nprobe: with an IVF partition (build_ivf), scan only the nprobe
        nearest coarse lists per query, plus the rows added since the
        partition: approximate in which rows are candidates, exact in their
        distances; recall -> the exhaustive scan's as nprobe -> nlist (ids then
        int64). None/0 = exhaustive. refine: with a refine store, re-rank the
        top refine*k ADC candidates by exact squared L2 to the stored vectors
        (ids then int64); composes with nprobe. precision "bf16" rounds the
        query LUTs to bf16, on the exhaustive routes only (the probed scan is
        exact f32 by design); it composes with refine, the recommended pairing
        when using it at all. Default "f32" matches the reference scanners.
        mesh is not ported yet (module parallel/, ROADMAP.md) and raises.
        """
        Q = self._queries(Q)
        if Q.ndim != 2 or Q.shape[1] != self.d:
            raise ValueError(f"queries must be [nq, {self.d}], got {tuple(Q.shape)}")
        if not 1 <= k <= self.n:
            raise ValueError(f"k={k} out of range [1, {self.n}]")
        if precision not in ("f32", "bf16"):
            raise ValueError(f"precision must be 'f32' or 'bf16', got {precision!r}")
        if mesh is not None:
            raise _not_ported("search(mesh=...), the sharded query", "parallel/")
        if precision != "f32" and nprobe is not None and nprobe != 0:
            raise ValueError(
                "precision='bf16' applies to the exhaustive scan routes; the IVF "
                "path scans probed candidates at exact f32 by design")
        if refine is not None and refine != 0:
            from local_search_quantization_torch.refine import rerank

            if self.refine is None:
                raise ValueError("refine given but no refine store; build with "
                                 "refine= or call attach_refine()")
            refine = int(refine)
            if refine < 1:
                raise ValueError(f"refine must be >= 1, got {refine}")
            cand = self.search(Q, min(refine * k, self.n), nprobe=nprobe,
                               precision=precision)
            # A +inf first-stage slot never reaches the re-ranker with a real
            # id: the exact distance would resurrect a tombstoned row.
            cand_ids = torch.where(torch.isfinite(cand.dists), cand.ids, -1)
            return rerank(self.refine, Q, cand_ids, k)
        if nprobe is not None and nprobe != 0:
            if self.ivf is None:
                raise ValueError("nprobe given but no IVF partition; call "
                                 "build_ivf() first")
            nprobe = int(nprobe)
            if nprobe < 1:
                raise ValueError(f"nprobe must be >= 1, got {nprobe}")
            return self._search_ivf(Q, k, nprobe)
        model, state = self.model, self._device_scan_state()
        if self.additive:
            R = model.R if self.method == "chainq" else None
            return adc.linscan_lsq(self.B, Q, model.C, self._dbn, k=k, R=R,
                                   precision=precision, device_state=state)
        if self.method == "opq":
            return adc.linscan_opq(self.B, Q, model.C_sub, model.R, k=k,
                                   extra=self._extra, precision=precision,
                                   device_state=state)
        return adc.linscan_pq(self.B, Q, model.C_sub, k=k, extra=self._extra,
                              precision=precision, device_state=state)

    def add(self, X) -> list[int]:
        """Encode X with the frozen model and append; returns the new ids.

        lsq encodes by ILS (condition mode "auto": K1 on a GPU) from random
        codes, with a generator seeded by the persisted counter `add_seq`,
        so delete + compact + add never repeats a seed.
        """
        from local_search_quantization_torch.models import (
            quantize_opq, quantize_pq, quantize_rvq,
        )
        from local_search_quantization_torch.ops import icm, norms, viterbi
        from local_search_quantization_torch.utils.synth import random_codes

        X = self._queries(X)
        if X.ndim != 2 or X.shape[1] != self.d:
            raise ValueError(f"vectors must be [n, {self.d}], got {tuple(X.shape)}")
        nreal = X.shape[0]
        model = self.model
        if self.method == "pq":
            Bn = _encode_chunked(lambda x: quantize_pq(x, model.C_sub), X, self.device)
        elif self.method == "opq":
            Bn = _encode_chunked(lambda x: quantize_opq(x, model.R, model.C_sub), X,
                                 self.device)
        elif self.method == "chainq":
            Bn = _encode_chunked(lambda x: viterbi.viterbi_encode(x @ model.R, model.C),
                                 X, self.device)
        elif self.method == "rvq":
            Bn = _encode_chunked(lambda x: quantize_rvq(x, model.C), X, self.device)
        else:  # lsq
            m, h = self.meta["m"], self.meta["h"]
            seq = int(self.meta.get("add_seq", 0))
            self.meta["add_seq"] = seq + 1
            gen = torch.Generator(device=self.device).manual_seed(seq)
            B0 = random_codes(seq, nreal, m, h)
            kw = dict(ilsiter=self.meta.get("ilsiter") or 16, icmiter=4,
                      npert=min(4, m), randord=True, condition_mode="auto")
            if nreal > _ENCODE_CHUNK:
                enc = icm.encode_chunked(gen, X, B0, model.C, **kw)
            else:
                enc = icm.ils_encode(gen, X, torch.as_tensor(B0), model.C, **kw)
            Bn = _host(enc.B).astype(np.int32)
        bn = None
        if self.additive:
            cbn = torch.as_tensor(self._cbnorms).to(self.device)
            bn = _host(norms.quantize_norms(Bn, model.C, cbn))
        n0 = self._append_rows(Bn, bn)
        if self.refine is not None:
            self.refine.append(X)  # frozen affine params
        return list(range(n0, n0 + nreal))

    def delete(self, ids) -> int:
        """Tombstone rows in O(1): their distance term becomes +inf, so no
        scan can return them; ids stay stable."""
        ids = np.asarray(_host(ids), np.int64)
        if ids.size and (ids.min() < 0 or ids.max() >= self.n):
            raise ValueError(f"delete ids out of range [0, {self.n})")
        self._tomb[ids] = True
        if self.additive:
            self._dbn[ids] = np.inf
        else:
            if self._extra_buf is None:
                self._extra_buf = np.zeros(self._B_buf.shape[0], np.float32)
            self._extra[ids] = np.inf
        if self.ivf is not None:
            self.ivf.tombstone(ids)  # mirror into the grouped store
        self._scan_ver += 1
        return int(ids.size)

    def compact(self) -> np.ndarray:
        """Drop tombstoned rows, renumbering the survivors densely.

        Returns old_of_new [active] int64: old_of_new[j] is the previous id
        of the row now serving as id j. Ids are NOT stable across a compact.
        An IVF partition is renumbered in place (list assignments kept).
        """
        keep = ~self._tomb
        if self.refine is not None:
            self.refine.take(keep)
        if self.ivf is not None:
            new_of_old = np.full(self.n, -1, np.int64)
            new_of_old[keep] = np.arange(int(keep.sum()))
            self.ivf.compact(new_of_old[: self.ivf.n_grouped])
        old_of_new = np.flatnonzero(keep)
        self._B_buf = np.ascontiguousarray(self.B[keep])
        if self.additive:
            self._bnorm_buf = self._bnorm[keep].copy()
            self._dbn_buf = np.ascontiguousarray(self._dbn[keep])
        else:
            self._extra_buf = None  # all survivors live: no carrier needed
        self._num = self._B_buf.shape[0]
        self._tomb_buf = np.zeros(self._num, bool)
        self.meta["n"] = self.n
        self._scan_ver += 1
        return old_of_new
