"""Device-dispatch discipline: the CUDA window path stays one window program,
one device->host copy and one wait per window — statically.

Counterpart of tieredstorage_tpu/analysis/dispatch.py, with the rules
rewritten in torch terms. The packed single-program GCM window is the
backend's production path (transform/cuda.py): one host->device copy, ONE
window program (ops/gcm.py: the AES and GHASH kernels and their glue)
writing its output into the staged buffer, one device->host copy back into
the pinned staging buffer, and one wait on the event that marks it ready.
``DispatchStats`` counts that at runtime (``d2h_fetches == dispatches``,
and ``== windows`` less the windows that shared a merged batcher flush);
this checker catches the regression at review time:

1. **Closure.** The static call closure of the hot window path — from
   ``CudaTransformBackend.transform_windows`` /
   ``_dispatch_encrypt_window`` / ``_encrypt_dispatch`` /
   ``_decrypt_batch``, the packed entry points of ``ops/gcm.py``, the
   device hot tier's serve path and the window batcher's submits and
   merged flush — resolved through imports, ``self`` methods and module
   functions, restricted to ``HOT_PATH_MODULES`` (the codecs have their
   own disciplines).

2. **Sync.** ``torch.cuda.synchronize()`` and any ``.synchronize()``
   (``Event``/``Stream``) inside the closure is a host wait: a finding
   outside the sanctioned finish set (``SANCTIONED_MATERIALIZERS``, each
   entry with its reason). A device-side ``wait_event``/``wait_stream`` —
   how the mesh forks and joins its member streams — orders streams
   without blocking the host and is not a finding.

3. **Materialization.** ``.item()``, ``.cpu()``, ``.tolist()``,
   ``.numpy()``, ``.tobytes()``, ``bytes(...)``, ``np.asarray``/
   ``np.array`` and ``int``/``float``/``bool`` read a device value to the
   host (a hidden wait): findings when their operand is *device-tainted*.
   Taint comes from the producers of ``DEVICE_PRODUCER_NAMES``, from
   ``.to(...)``/``.cuda(...)``, from any ``torch.*`` factory given a
   ``device=`` keyword, and from the kernel wrappers that launch through
   ``ops/_cuda.py`` (found mechanically). A pinned host staging tensor is
   not tainted — packing the window into it is host work, the point of
   the path — and neither are metadata probes (``.shape``, ``.dtype``,
   ``.device``, ``.nbytes``, ``.data_ptr()``...), which read no device
   memory.

4. **Context caches.** Torch has no trace-compiled program, so the JAX
   package's ``jax.jit`` retrace rule has no counterpart here. The
   context-cache half stays: ``GcmContext``/``GcmVarlenContext``
   construction or ``_context_cached``/``_varlen_context_cached`` calls
   outside ``ops/gcm.py`` bypass ``make_context``/``make_varlen_context``,
   so the window shape skips ``bucket_max_bytes``'s ladder — one context,
   one set of device constants and one staging-buffer shape per distinct
   size.

5. **In-place output.** ``_launch_packed`` (and any packed call with
   ``donate=True``) has the window program write its output into the
   staged buffer, the counterpart of XLA buffer donation. A load of the
   donated name on a later line of the same function reads ciphertext
   where plaintext was (or the reverse): a finding — ``.data_ptr()``
   excepted, the probe that the output really is the staged buffer.

6. **The window-program closure.** A second closure from
   ``WINDOW_CLOSURE_ROOTS`` (``_fixed_window``/``_varlen_window``, one
   window program on one device) holds everything that runs between the
   window's host->device copy and its device->host copy. Any host sync or
   materializer there, whatever its operand, is a finding
   (``interstage:...``): the program must never wait for its own kernels.
   The closure stops at the sanctioned functions and at the kernels' plain
   versions (``PLAIN_VERSIONS``), which run only for CPU tensors. A
   matmul inside a loop there is a staged reduction (one device-memory
   round trip per level, ``interstage:staged-ladder``) outside the
   sanctioned ladder of ``_ghash_grouped``.

Like the other whole-project checkers this is an over-approximation with
explicit limits: taint does not flow through containers, attributes or
calls, and lexical line order stands in for execution order. The runtime
counters (``DispatchStats``, ``ops.gcm.device_dispatches``,
``ops._cuda.launch_counts``) remain the ground truth.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Optional

from tieredstorage_tpu_torch.analysis import lockorder
from tieredstorage_tpu_torch.analysis.core import Finding, Project

_CUDA = "tieredstorage_tpu_torch/transform/cuda.py"
_GCM = "tieredstorage_tpu_torch/ops/gcm.py"
_HOT = "tieredstorage_tpu_torch/fetch/cache/device_hot.py"
_BATCHER = "tieredstorage_tpu_torch/transform/batcher.py"

#: Entry points of the hot window path (summary keys). The device hot tier
#: covers the serve side: a resident decrypt tensor must be SLICED on the
#: device, never materialized mid-serve. The batcher is the window path
#: under concurrency: a hidden materialization in a submit or the merged
#: flush would pay once per coalesced launch and stall every waiter at once.
HOT_PATH_ROOTS = (
    f"{_CUDA}:CudaTransformBackend.transform_windows",
    f"{_CUDA}:CudaTransformBackend._dispatch_encrypt_window",
    f"{_CUDA}:CudaTransformBackend._encrypt_dispatch",
    f"{_CUDA}:CudaTransformBackend._decrypt_batch",
    f"{_GCM}:gcm_window_packed",
    f"{_GCM}:gcm_varlen_window_packed",
    f"{_HOT}:DeviceHotCache.get_chunks",
    f"{_HOT}:DeviceHotCache.device_rows",
    f"{_BATCHER}:WindowBatcher.submit",
    f"{_BATCHER}:WindowBatcher.submit_encrypt",
    f"{_BATCHER}:WindowBatcher._flush_group",
)

#: Modules the closure may traverse: the window path and the kernel stack
#: under it. The compression codecs (thuff/lzhuff/zstd) materialize on
#: their own schedules and stay outside.
HOT_PATH_MODULES = (
    _CUDA,
    _GCM,
    "tieredstorage_tpu_torch/ops/gf128.py",
    "tieredstorage_tpu_torch/ops/aes.py",
    "tieredstorage_tpu_torch/ops/aes_bitsliced.py",
    "tieredstorage_tpu_torch/ops/_cuda.py",
    "tieredstorage_tpu_torch/ops/ghash_cuda.py",
    "tieredstorage_tpu_torch/parallel/mesh.py",
    _HOT,
    _BATCHER,
    "tieredstorage_tpu_torch/transform/scheduler.py",
)

#: Functions allowed to wait on the device or materialize device values,
#: with the reason. This is the "finish set": burn entries down, never add
#: one without a sentence.
SANCTIONED_MATERIALIZERS = {
    f"{_CUDA}:CudaTransformBackend._fetch":
        "the window's ONE wait: ready.synchronize() on the event recorded "
        "after the device->host copy into the pinned staging buffer, once "
        "pipeline_depth newer windows were dispatched",
    f"{_CUDA}:CudaTransformBackend._encrypt_finish":
        "encrypt finish half: the wire format (IV || ct || tag) read out "
        "of the pinned staging buffer _fetch waited on",
    f"{_CUDA}:CudaTransformBackend._decrypt_window":
        "decrypt finish half: one fetch of plaintext + expected tags, "
        "verified host-side (the launch half is checked upstream)",
    f"{_BATCHER}:WindowBatcher._flush_group":
        "the merged flush's ONE wait and device->host copy, demultiplexed "
        "to every coalesced waiter with per-row tag verification (the "
        "batched counterpart of _decrypt_window)",
    f"{_GCM}:_derive_h":
        "once-per-key host precompute of the GHASH key H, lru_cached - "
        "never on the per-window path",
    f"{_GCM}:_host_tensor":
        "caller-supplied host metadata (explicit IVs or lengths) and a "
        "context's numpy constants copied TO the device: a host->device "
        "copy of a host array, never a read of a device value",
}

#: The kernels' plain PyTorch versions: the wrappers take them only for CPU
#: tensors, so they never run on the card's window path (their loops are
#: the reference's shape, held against the kernels by the tests). The
#: window-program closure does not enter them.
PLAIN_VERSIONS = {
    "tieredstorage_tpu_torch/ops/aes_bitsliced.py:ctr_keystream_batch_plain",
    "tieredstorage_tpu_torch/ops/ghash_cuda.py:ghash_level1_plain",
    "tieredstorage_tpu_torch/ops/ghash_cuda.py:ghash_tree_plain",
}

#: Roots of the window-program closure: one window program on one device
#: (the mesh runs one per member), from the staged input to the output
#: written in place.
WINDOW_CLOSURE_ROOTS = (
    f"{_GCM}:_fixed_window",
    f"{_GCM}:_varlen_window",
)

#: Window-program functions allowed to contain a staged matmul-reduction
#: loop, with the reason. Burn down, never add without a sentence.
SANCTIONED_STAGED_REDUCERS = {
    f"{_GCM}:_ghash_grouped":
        "the torch ladder runs only for a context without a fold matrix "
        "(context_from_numpy of a source with step_mat=None): every "
        "context this package makes has one, so with more than one group "
        "the GHASH tree kernel does the whole reduction; the ladder's "
        "per-level round trips are counted by planned_hbm_roundtrips",
}

#: Calls that produce (or carry) device values: assignment from one taints
#: the bound name for the rest of the function. The kernel wrappers that
#: launch through ops/_cuda.py are added mechanically (`_launchers`).
DEVICE_PRODUCER_NAMES = {
    "gcm_window_packed", "gcm_varlen_window_packed",
    "gcm_encrypt_chunks", "gcm_decrypt_chunks",
    "gcm_encrypt_varlen", "gcm_decrypt_varlen", "_run_varlen",
    "_launch_packed", "_stage_packed", "_encrypt_dispatch",
    "_dispatch_encrypt_window",
    "_gcm_process_batch", "_gcm_varlen_batch",
    "_fixed_window", "_varlen_window", "_window_target", "_rows_on",
    "shard_rows", "_split_rows", "run_on_members",
    # Device hot-cache tier: retained decrypt rows stay device values.
    "device_rows", "offer_decrypt_window",
}
#: Tensor methods whose result lives on a (possibly) device: taint.
DEVICE_PRODUCER_ATTRS = {"to", "cuda"}

#: Parameters conventionally carrying staged device buffers.
DEVICE_PARAM_NAMES = {"staged", "data_packed"}

#: Materializers: findings on device-tainted operands in the hot closure,
#: on any operand in the window-program closure.
MATERIALIZE_CALL_NAMES = {
    "np.asarray", "np.array", "np.copy", "numpy.asarray", "numpy.array",
    "float", "int", "bool", "bytes",
}
MATERIALIZE_ATTRS = {"item", "cpu", "tolist", "numpy", "tobytes"}
#: Host waits on the device: findings on ANY operand inside the closure.
SYNC_ATTRS = {"synchronize"}
SYNC_CALL_NAMES = {"torch.cuda.synchronize"}

#: Attribute reads of a tensor that touch no device memory: names under
#: them are not device operands.
METADATA_ATTRS = {
    "shape", "dtype", "device", "nbytes", "ndim", "is_cuda", "data_ptr",
    "dim", "numel", "size", "element_size", "is_contiguous", "stride",
}

#: Attribute reads of a buffer the program wrote into that are still legal.
ALLOWED_AFTER_DONATE = {"data_ptr"}

#: Calls that write their output into an operand -> its positional index.
_DONATING_CALLS = {
    "gcm_window_packed": 2,
    "gcm_varlen_window_packed": 2,
    "_launch_packed": 2,  # self._launch_packed(ctx, host, staged, ...)
}

#: Names of a matmul inside a loop (the `@` operator counts too).
_MATMUL_NAMES = {"matmul", "mm", "bmm", "einsum", "tensordot", "dot"}


# ---------------------------------------------------------------- closure
@dataclasses.dataclass
class _Fn:
    key: str
    rel_path: str
    qualname: str
    node: ast.FunctionDef
    fm: object
    class_name: Optional[str]


def _module_index(file_models: dict) -> dict[str, str]:
    return {fm.module_name: rel for rel, fm in file_models.items()}


def _resolve_call(func: ast.AST, fn: _Fn, modules: dict[str, str]) -> Optional[str]:
    """Summary key for a call target: local/module functions, imported
    module functions (``from x import f`` and ``import x as y; y.f()``),
    and ``self`` methods."""
    fm = fn.fm
    if isinstance(func, ast.Name):
        if func.id in fm.functions:
            return f"{fn.rel_path}:{func.id}"
        dotted = fm.imports.get(func.id)
        if dotted and "." in dotted:
            mod, _, name = dotted.rpartition(".")
            rel = modules.get(mod)
            if rel is not None:
                return f"{rel}:{name}"
        return None
    if not isinstance(func, ast.Attribute):
        return None
    recv, meth = func.value, func.attr
    if isinstance(recv, ast.Name) and recv.id == "self" and fn.class_name:
        cm = fm.classes.get(fn.class_name)
        if cm is not None and meth in cm.methods:
            return f"{fn.rel_path}:{fn.class_name}.{meth}"
        return None
    dotted = lockorder._dotted(func)
    if dotted and "." in dotted:
        head, _, rest = dotted.partition(".")
        base = fm.imports.get(head)
        if base:
            full = f"{base}.{rest}"
            mod, _, name = full.rpartition(".")
            rel = modules.get(mod)
            if rel is not None:
                return f"{rel}:{name}"
    return None


def _functions(project: Project):
    """(every function of the hot-path modules by key, module index)."""
    file_models = {
        pf.rel_path: lockorder._build_file_model(pf)
        for pf in project.files
        if pf.rel_path in HOT_PATH_MODULES
    }
    modules = _module_index(file_models)
    fns: dict[str, _Fn] = {}
    for rel, fm in file_models.items():
        for name, node in fm.functions.items():
            fns[f"{rel}:{name}"] = _Fn(
                key=f"{rel}:{name}", rel_path=rel, qualname=name,
                node=node, fm=fm, class_name=None,
            )
        for cls_name, cm in fm.classes.items():
            for m, node in cm.methods.items():
                key = f"{rel}:{cls_name}.{m}"
                fns[key] = _Fn(
                    key=key, rel_path=rel, qualname=f"{cls_name}.{m}",
                    node=node, fm=fm, class_name=cls_name,
                )
    return fns, modules


def build_closure(project: Project, roots=HOT_PATH_ROOTS, stop_at=()):
    """(closure functions by key, module index) — exposed for tests.
    `roots` selects the entry set: the hot window path (default) or
    WINDOW_CLOSURE_ROOTS for one window program. Functions in `stop_at` are
    kept in the closure but their callees are not traversed."""
    fns, modules = _functions(project)
    closure: dict[str, _Fn] = {}
    stack = [k for k in roots if k in fns]
    while stack:
        key = stack.pop()
        if key in closure:
            continue
        fn = fns.get(key)
        if fn is None:
            continue
        closure[key] = fn
        if key in stop_at:
            continue
        for node in ast.walk(fn.node):
            if isinstance(node, ast.Call):
                callee = _resolve_call(node.func, fn, modules)
                if callee is not None and callee not in closure:
                    stack.append(callee)
    return closure, modules


def _launchers(project: Project) -> set[str]:
    """Names of the kernel wrappers: hot-path functions that launch a
    kernel through ``ops/_cuda.py`` (``_cuda.launch(...)``). Their results
    are device tensors."""
    names: set[str] = set()
    fns, _ = _functions(project)
    for fn in fns.values():
        for node in ast.walk(fn.node):
            if isinstance(node, ast.Call):
                name = _call_name(node.func) or ""
                if name == "_cuda.launch" or name.endswith("ops._cuda.launch"):
                    names.add(fn.qualname.split(".")[-1])
                    break
    return names


# ------------------------------------------------------------------ taint
def _call_name(func: ast.AST) -> Optional[str]:
    return lockorder._dotted(func)


def _is_producer(call: ast.Call, producers: set[str]) -> bool:
    func = call.func
    name = _call_name(func)
    if name is not None and name.split(".")[-1] in producers:
        return True
    if isinstance(func, ast.Attribute) and func.attr in DEVICE_PRODUCER_ATTRS:
        return True
    return bool(
        name is not None
        and name.startswith("torch.")
        and any(kw.arg == "device" for kw in call.keywords)
    )


def _operand_tainted(expr: ast.AST, tainted: set[str], producers: set[str]) -> bool:
    """Whether `expr` reads a device value: a tainted name or a producer
    call anywhere in it, except under a metadata probe."""
    if isinstance(expr, ast.Attribute) and expr.attr in METADATA_ATTRS:
        return False
    if isinstance(expr, ast.Name):
        return expr.id in tainted
    if isinstance(expr, ast.Call):
        if _is_producer(expr, producers):
            return True
        if isinstance(expr.func, ast.Attribute) and expr.func.attr in METADATA_ATTRS:
            return False
    return any(
        _operand_tainted(child, tainted, producers)
        for child in ast.iter_child_nodes(expr)
    )


def _receiver_tainted(expr: ast.AST, tainted: set[str], producers: set[str]) -> bool:
    """A method receiver is a device value when it is a tainted name, an
    index of one, or a producer call (fields of a tainted record are not:
    ``staged.host`` is the pinned host buffer)."""
    while isinstance(expr, ast.Subscript):
        expr = expr.value
    if isinstance(expr, ast.Name):
        return expr.id in tainted
    if isinstance(expr, ast.Call):
        return _is_producer(expr, producers) or (
            isinstance(expr.func, ast.Attribute)
            and expr.func.attr not in METADATA_ATTRS
            and _receiver_tainted(expr.func.value, tainted, producers)
        )
    return False


def _tainted_names(fn: _Fn, producers: set[str]) -> set[str]:
    """Names bound (directly or via tuple unpack) from device producers or
    tainted names, plus conventionally named device parameters. Two passes
    so a name assigned from another tainted name late in the function
    still taints earlier reported uses conservatively."""
    tainted: set[str] = {
        a.arg for a in fn.node.args.args if a.arg in DEVICE_PARAM_NAMES
    }
    for _ in range(2):
        for node in ast.walk(fn.node):
            if isinstance(node, ast.Assign) and _operand_tainted(
                node.value, tainted, producers
            ):
                for target in node.targets:
                    elts = target.elts if isinstance(target, ast.Tuple) else [target]
                    for t in elts:
                        if isinstance(t, ast.Name):
                            tainted.add(t.id)
    return tainted


# ------------------------------------------------------------------ scans
def _sync_label(call: ast.Call) -> Optional[str]:
    func = call.func
    name = _call_name(func)
    if name in SYNC_CALL_NAMES:
        return name
    if isinstance(func, ast.Attribute) and func.attr in SYNC_ATTRS:
        return func.attr
    return None


def _is_materializer(call: ast.Call) -> bool:
    func = call.func
    return _call_name(func) in MATERIALIZE_CALL_NAMES or (
        isinstance(func, ast.Attribute) and func.attr in MATERIALIZE_ATTRS
    )


def _label(call: ast.Call) -> str:
    return (_call_name(call.func) or call.func.attr).split(".")[-1]


def _scan_materialization(fn: _Fn, producers: set[str], findings: list[Finding]) -> None:
    if fn.key in SANCTIONED_MATERIALIZERS:
        return
    tainted = _tainted_names(fn, producers)
    for node in ast.walk(fn.node):
        if not isinstance(node, ast.Call):
            continue
        sync = _sync_label(node)
        if sync is not None:
            findings.append(Finding(
                checker="device-dispatch",
                path=fn.rel_path, line=node.lineno, qualname=fn.qualname,
                detail=f"sync:{sync}",
                message=(
                    f"{sync}() inside the window-path closure blocks the "
                    "host on the device and serializes the staging "
                    "pipeline; only the sanctioned finish set may wait, "
                    "on the window's one ready event"
                ),
            ))
            continue
        if not _is_materializer(node):
            continue
        func = node.func
        receiver = isinstance(func, ast.Attribute) and _receiver_tainted(
            func.value, tainted, producers
        )
        operands = list(node.args) + [kw.value for kw in node.keywords]
        if receiver or any(_operand_tainted(a, tainted, producers) for a in operands):
            label = _label(node)
            findings.append(Finding(
                checker="device-dispatch",
                path=fn.rel_path, line=node.lineno, qualname=fn.qualname,
                detail=f"materialize:{label}",
                message=(
                    f"{label}() reads a device value to the host inside the "
                    "window-path closure (outside the sanctioned finish "
                    "set): the hidden wait stalls the pipeline; keep the "
                    "value on the device or move the read into the finish "
                    "half"
                ),
            ))


def _scan_context_bypass(fn: _Fn, findings: list[Finding]) -> None:
    if fn.rel_path == _GCM:
        return
    for node in ast.walk(fn.node):
        if not isinstance(node, ast.Call):
            continue
        name = _call_name(node.func)
        last = name.split(".")[-1] if name else None
        if last in ("GcmContext", "GcmVarlenContext",
                    "_context_cached", "_varlen_context_cached"):
            findings.append(Finding(
                checker="device-dispatch",
                path=fn.rel_path, line=node.lineno, qualname=fn.qualname,
                detail=f"shape-not-bucketed:{last}",
                message=(
                    f"{last} constructed outside ops/gcm.py bypasses "
                    "make_context/make_varlen_context, so the window shape "
                    "does not flow through bucket_max_bytes's ladder: one "
                    "context, one upload of device constants and one "
                    "staging-buffer shape per distinct size"
                ),
            ))


def _scan_donation(fn: _Fn, findings: list[Finding]) -> None:
    donated: list[tuple[str, int]] = []  # (name, last line of the donating call)
    in_donating_call: set[int] = set()   # id() of Name nodes inside one
    for node in ast.walk(fn.node):
        if not isinstance(node, ast.Call):
            continue
        name = _call_name(node.func)
        last = name.split(".")[-1] if name else None
        if last not in _DONATING_CALLS:
            continue
        if last != "_launch_packed" and not any(
            kw.arg == "donate"
            and isinstance(kw.value, ast.Constant)
            and kw.value.value is True
            for kw in node.keywords
        ):
            continue
        # A later donating call (the fixed/varlen sibling branch) passing
        # the same buffer is not a read after the write: one branch runs.
        for sub in ast.walk(node):
            if isinstance(sub, ast.Name):
                in_donating_call.add(id(sub))
        idx = _DONATING_CALLS[last]
        if idx < len(node.args) and isinstance(node.args[idx], ast.Name):
            donated.append((node.args[idx].id, node.end_lineno or node.lineno))
    if not donated:
        return
    seen_fp: set[str] = set()
    for node in ast.walk(fn.node):
        if not (isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load)):
            continue
        if id(node) in in_donating_call:
            continue
        parent = getattr(node, "_ts_parent", None)
        if (
            isinstance(parent, ast.Attribute)
            and parent.attr in ALLOWED_AFTER_DONATE
        ):
            continue
        for dname, dline in donated:
            if node.id == dname and node.lineno > dline:
                f = Finding(
                    checker="device-dispatch",
                    path=fn.rel_path, line=node.lineno, qualname=fn.qualname,
                    detail=f"use-after-donate:{dname}",
                    message=(
                        f"{dname!r} was handed to the window program as its "
                        "output buffer and now holds the output, not the "
                        "input; reading it here reads the other direction's "
                        "bytes (only .data_ptr() is legal - it is the "
                        "in-place probe)"
                    ),
                )
                if f.fingerprint not in seen_fp:
                    seen_fp.add(f.fingerprint)
                    findings.append(f)


# ----------------------------------------------- window-program closure
def _scan_window(fn: _Fn, findings: list[Finding]) -> None:
    """Host syncs and materializers inside one window program, whatever
    the operand: the program runs between the window's two copies and must
    never wait for its own kernels."""
    for node in ast.walk(fn.node):
        if not isinstance(node, ast.Call):
            continue
        sync = _sync_label(node)
        if sync is not None:
            findings.append(Finding(
                checker="device-dispatch",
                path=fn.rel_path, line=node.lineno, qualname=fn.qualname,
                detail=f"interstage:sync:{sync.split('.')[-1]}",
                message=(
                    "host wait inside the window program: the window must "
                    "stay one program between its host->device and "
                    "device->host copies; move host work outside "
                    "_fixed_window/_varlen_window"
                ),
            ))
        elif _is_materializer(node):
            label = _label(node)
            findings.append(Finding(
                checker="device-dispatch",
                path=fn.rel_path, line=node.lineno, qualname=fn.qualname,
                detail=f"interstage:materialize:{label}",
                message=(
                    f"{label}() inside the window program: a host read "
                    "there waits for the kernels launched before it and "
                    "cuts the window's one program in two"
                ),
            ))


def _has_matmul(node: ast.AST, matmul_fns: set[str], fn: _Fn, modules) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.BinOp) and isinstance(sub.op, ast.MatMult):
            return True
        if isinstance(sub, ast.Call):
            name = _call_name(sub.func) or ""
            if name.split(".")[-1] in _MATMUL_NAMES:
                return True
            if _resolve_call(sub.func, fn, modules) in matmul_fns:
                return True
    return False


def _scan_staged_reduction(
    fn: _Fn, matmul_fns: set[str], modules, findings: list[Finding]
) -> None:
    """A matmul inside a loop in the window program is a STAGED reduction:
    each iteration writes its node tensor to device memory before the next
    contracts it. A call to a helper whose body is a matmul counts as one.
    Only the sanctioned ladder may carry one."""
    if fn.key in SANCTIONED_STAGED_REDUCERS:
        return
    for loop in ast.walk(fn.node):
        if isinstance(loop, (ast.For, ast.While)) and _has_matmul(
            loop, matmul_fns, fn, modules
        ):
            findings.append(Finding(
                checker="device-dispatch",
                path=fn.rel_path, line=loop.lineno, qualname=fn.qualname,
                detail="interstage:staged-ladder",
                message=(
                    "matmul-in-a-loop inside the window program is a "
                    "staged reduction (one device-memory round trip per "
                    "level); the ladder lives only in the sanctioned "
                    "fallback - route the reduction through the GHASH "
                    "tree kernel instead"
                ),
            ))


def check_device_dispatch(project: Project) -> list[Finding]:
    closure, modules = build_closure(project)
    producers = DEVICE_PRODUCER_NAMES | _launchers(project)
    findings: list[Finding] = []
    for key in sorted(closure):
        fn = closure[key]
        _scan_materialization(fn, producers, findings)
        _scan_context_bypass(fn, findings)
        _scan_donation(fn, findings)
    skip = frozenset(SANCTIONED_MATERIALIZERS) | PLAIN_VERSIONS
    window, _ = build_closure(project, WINDOW_CLOSURE_ROOTS, stop_at=skip)
    matmul_fns = {
        key for key, fn in window.items()
        if key not in skip and any(
            isinstance(sub, ast.BinOp) and isinstance(sub.op, ast.MatMult)
            for sub in ast.walk(fn.node)
        )
    }
    for key in sorted(window):
        if key in skip:
            continue
        fn = window[key]
        _scan_window(fn, findings)
        _scan_staged_reduction(fn, matmul_fns, modules, findings)
    return findings
