"""The port's device-dispatch checker (analysis/dispatch.py), in torch terms.

One fixture per rule — host sync, device-value materialization (with the
taint sources and the pinned-host and metadata-probe exemptions), the
context-cache bypass, the read of a buffer the window program wrote into,
and the window-program closure's sync/materializer/staged-ladder rules —
each flagged, and each passing case clean. Then the rules are seeded into a
`tmp_path` copy of the port's real hot-path modules and must be flagged at
the seeded line; the real tree is clean and its closures are not empty.
"""

from __future__ import annotations

import pathlib
import shutil
import textwrap

import pytest

from tieredstorage_tpu_torch.analysis import dispatch
from tieredstorage_tpu_torch.analysis.core import load_project, run_analysis

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]
CUDA = "tieredstorage_tpu_torch/transform/cuda.py"
GCM = "tieredstorage_tpu_torch/ops/gcm.py"
GHASH = "tieredstorage_tpu_torch/ops/ghash_cuda.py"

#: Minimal hot-path skeleton: the checker engages through the ROOT names.
SKELETON = {
    CUDA: """
        import numpy as np
        import torch

        from tieredstorage_tpu_torch.ops.gcm import gcm_window_packed, make_context

        class CudaTransformBackend:
            def transform_windows(self, windows, opts):
                for window in windows:
                    staged = self._dispatch_encrypt_window(window, opts)
                    yield self._encrypt_finish(staged)

            def _dispatch_encrypt_window(self, chunks, opts):
                return self._encrypt_dispatch(chunks, opts)

            def _encrypt_dispatch(self, chunks, opts):
                host = torch.empty((len(chunks), 32), dtype=torch.uint8, pin_memory=True)
                packed = host.numpy()
                packed[:] = 0
                ctx = make_context(opts.key, b"", 16)
                staged = self._stage_packed(host)
                out, ready = self._launch_packed(ctx, host, staged, False)
                return host, ready

            def _stage_packed(self, host):
                staged = torch.empty(host.shape, dtype=torch.uint8, device=self.device)
                staged.copy_(host, non_blocking=True)
                return staged

            def _launch_packed(self, ctx, host, staged, varlen):
                out = gcm_window_packed(ctx, None, staged, decrypt=False, donate=True)
                donated = out.data_ptr() == staged.data_ptr()
                host.copy_(out, non_blocking=True)
                ready = torch.cuda.Event()
                return out, ready

            def _fetch(self, staged):
                staged.ready.synchronize()
                return staged.host.numpy()

            def _encrypt_finish(self, staged):
                return self._fetch(staged).tobytes()

            def _decrypt_batch(self, chunks, opts):
                return chunks
    """,
    GCM: """
        import torch

        def make_context(key, aad, chunk_bytes):
            return _context_cached(key, aad, chunk_bytes)

        def _context_cached(key, aad, chunk_bytes):
            return GcmContext(key, aad, chunk_bytes)

        class GcmContext:
            def __init__(self, key, aad, chunk_bytes):
                self.key = key

        def _fixed_window(ctx, ivs, data_packed, *, decrypt, donate):
            target = data_packed if donate else data_packed.clone()
            return _process(target)

        def _varlen_window(ctx, ivs, data_packed, lengths, *, decrypt, donate):
            return _process(data_packed)

        def _process(data):
            return data ^ 1

        def gcm_window_packed(ctx, ivs, data_packed, *, decrypt, donate=False):
            return _fixed_window(ctx, ivs, data_packed, decrypt=decrypt, donate=donate)

        def gcm_varlen_window_packed(ctx, ivs, data_packed, lengths, *, decrypt, donate=False):
            return _varlen_window(ctx, ivs, data_packed, lengths, decrypt=decrypt, donate=donate)
    """,
}


def make_project(tmp_path, files):
    for rel, src in files.items():
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(src))
    return load_project(tmp_path, sorted(files))


def skeleton_with(tmp_path, extra=None, **edits):
    """The skeleton with `edits` ({short name: (anchor, replacement)}, on the
    raw text so indentation matches) and `extra` files."""
    files = dict(SKELETON)
    names = {"cuda": CUDA, "gcm": GCM}
    for short, (old, new) in edits.items():
        rel = names[short]
        assert old in files[rel], f"skeleton anchor missing: {old!r}"
        files[rel] = files[rel].replace(old, new)
    files.update(extra or {})
    return make_project(tmp_path, files)


def details(project):
    return sorted(f.detail for f in run_analysis(project, only=["device-dispatch"]).findings)


DISPATCH = "                staged = self._stage_packed(host)\n"
LAUNCH = "                donated = out.data_ptr() == staged.data_ptr()\n"


def test_skeleton_is_clean(tmp_path):
    assert details(skeleton_with(tmp_path)) == []


# ------------------------------------------------------------------ sync
@pytest.mark.parametrize("line,detail", [
    ("torch.cuda.synchronize()", "sync:torch.cuda.synchronize"),
    ("torch.cuda.Event().synchronize()", "sync:synchronize"),
    ("torch.cuda.current_stream().synchronize()", "sync:synchronize"),
])
def test_host_sync_flagged(tmp_path, line, detail):
    project = skeleton_with(tmp_path, cuda=(DISPATCH, DISPATCH + f"                {line}\n"))
    assert details(project) == [detail]


@pytest.mark.parametrize("line", [
    "torch.cuda.current_stream().wait_stream(torch.cuda.Stream())",
    "torch.cuda.current_stream().wait_event(torch.cuda.Event())",
])
def test_device_side_waits_are_not_host_syncs(tmp_path, line):
    project = skeleton_with(tmp_path, cuda=(DISPATCH, DISPATCH + f"                {line}\n"))
    assert details(project) == []


def test_sync_in_the_sanctioned_finish_set_allowed(tmp_path):
    """`_fetch`'s `ready.synchronize()` is the window's one wait."""
    project = skeleton_with(tmp_path)
    closure, _ = dispatch.build_closure(project)
    assert f"{CUDA}:CudaTransformBackend._fetch" in closure
    assert details(project) == []


# ------------------------------------------------------- materialization
@pytest.mark.parametrize("line,detail", [
    ("dev = torch.empty((4,), device=self.device)\n                _ = dev.item()",
     "materialize:item"),
    ("dev = host.to(self.device)\n                _ = dev.cpu()", "materialize:cpu"),
    ("dev = host.cuda()\n                _ = dev.tolist()", "materialize:tolist"),
    ("dev = torch.zeros(4, device='cuda:0')\n                _ = dev[0].numpy()",
     "materialize:numpy"),
    ("_ = bytes(self._stage_packed(host))", "materialize:bytes"),
    ("dev = self._stage_packed(host)\n                _ = int(dev)", "materialize:int"),
    ("dev = self._stage_packed(host)\n                _ = float(dev.sum())", "materialize:float"),
    ("dev = self._stage_packed(host)\n                _ = np.asarray(dev)", "materialize:asarray"),
    ("dev = self._stage_packed(host)\n                _ = np.array(dev + 1)", "materialize:array"),
    ("dev = self._stage_packed(host)\n                _ = bool(dev.any())", "materialize:bool"),
])
def test_device_value_materialization_flagged(tmp_path, line, detail):
    project = skeleton_with(tmp_path, cuda=(DISPATCH, DISPATCH + f"                {line}\n"))
    assert details(project) == [detail]


@pytest.mark.parametrize("line", [
    # The pinned host staging tensor: packing the window is host work.
    "pinned = torch.empty((4, 32), dtype=torch.uint8, pin_memory=True)\n"
    "                _ = pinned.numpy()",
    "_ = host.numpy().tobytes()",
    # Metadata probes read no device memory.
    "dev = self._stage_packed(host)\n                _ = int(dev.shape[0])",
    "dev = self._stage_packed(host)\n                _ = int(dev.numel()) + int(dev.nbytes)",
    "dev = self._stage_packed(host)\n                _ = bool(dev.is_contiguous())",
    # A host numpy array is not a device value.
    "_ = np.asarray([1, 2, 3])",
])
def test_host_values_not_flagged(tmp_path, line):
    project = skeleton_with(tmp_path, cuda=(DISPATCH, DISPATCH + f"                {line}\n"))
    assert details(project) == []


def test_kernel_wrappers_taint_mechanically(tmp_path):
    """A function that launches through ops/_cuda.py produces a device
    tensor, whatever its name."""
    launcher = {GHASH: """
        import torch

        from tieredstorage_tpu_torch.ops import _cuda

        def fold_kernel(data):
            out = torch.empty_like(data)
            _cuda.launch("fold", data.data_ptr(), out.data_ptr(), rows=1)
            return out
    """, "tieredstorage_tpu_torch/ops/_cuda.py": """
        def launch(name, *args, rows):
            return None
    """}
    project = skeleton_with(
        tmp_path, extra=launcher,
        cuda=(DISPATCH, DISPATCH + "                _ = fold_kernel(staged).cpu()\n"),
    )
    assert "fold_kernel" in dispatch._launchers(project)
    assert details(project) == ["materialize:cpu"]


def test_functions_outside_the_closure_not_scanned(tmp_path):
    project = skeleton_with(tmp_path, cuda=(
        "            def _decrypt_batch(self, chunks, opts):",
        "            def unrelated(self):\n"
        "                torch.cuda.synchronize()\n\n"
        "            def _decrypt_batch(self, chunks, opts):",
    ))
    assert details(project) == []


# --------------------------------------------------------- context caches
@pytest.mark.parametrize("call,detail", [
    ("GcmContext(opts.key, b'', 16)", "shape-not-bucketed:GcmContext"),
    ("gcm._varlen_context_cached(opts.key, b'', 100)",
     "shape-not-bucketed:_varlen_context_cached"),
])
def test_context_bypass_flagged(tmp_path, call, detail):
    project = skeleton_with(tmp_path, cuda=(DISPATCH, DISPATCH + f"                _ = {call}\n"))
    assert details(project) == [detail]


def test_context_construction_inside_gcm_allowed(tmp_path):
    project = skeleton_with(tmp_path)
    closure, _ = dispatch.build_closure(project)
    assert f"{GCM}:_context_cached" in closure  # constructs GcmContext: legal there
    assert details(project) == []


# ------------------------------------------------------ in-place output
def test_read_after_the_in_place_launch_flagged(tmp_path):
    project = skeleton_with(tmp_path, cuda=(LAUNCH, LAUNCH + "                _ = staged[0]\n"))
    assert details(project) == ["use-after-donate:staged"]


def test_read_after_launch_packed_flagged(tmp_path):
    anchor = "                out, ready = self._launch_packed(ctx, host, staged, False)\n"
    project = skeleton_with(tmp_path, cuda=(anchor, anchor + "                _ = staged + 1\n"))
    assert details(project) == ["use-after-donate:staged"]


def test_data_ptr_after_the_in_place_launch_allowed(tmp_path):
    project = skeleton_with(tmp_path, cuda=(
        LAUNCH, LAUNCH + "                _ = staged.data_ptr() + 1\n"))
    assert details(project) == []


def test_sibling_branch_launch_not_flagged(tmp_path):
    old = "                out = gcm_window_packed(ctx, None, staged, decrypt=False, donate=True)\n"
    new = ("                if varlen:\n"
           "                    out = gcm_window_packed(ctx, None, staged, decrypt=True, donate=True)\n"
           "                else:\n"
           "                    out = gcm_window_packed(ctx, None, staged, decrypt=False, donate=True)\n")
    assert details(skeleton_with(tmp_path, cuda=(old, new))) == []


def test_call_without_donate_not_tracked(tmp_path):
    old = "                out = gcm_window_packed(ctx, None, staged, decrypt=False, donate=True)\n"
    new = ("                out = gcm_window_packed(ctx, None, staged, decrypt=False)\n"
           "                _ = staged[0]\n")
    assert details(skeleton_with(tmp_path, cuda=(old, new))) == []


# ------------------------------------------------ window-program closure
PROCESS = "            return data ^ 1\n"


@pytest.mark.parametrize("line,expected", [
    ("_ = data.item()", ["interstage:materialize:item"]),
    ("_ = int(4)", ["interstage:materialize:int"]),
    ("_ = data.cpu()", ["interstage:materialize:cpu"]),
    # The window program is on the hot path too, where a sync is one anywhere.
    ("torch.cuda.synchronize()", ["interstage:sync:synchronize", "sync:torch.cuda.synchronize"]),
])
def test_window_program_host_reads_flagged_whatever_the_operand(tmp_path, line, expected):
    project = skeleton_with(tmp_path, gcm=(PROCESS, f"            {line}\n" + PROCESS))
    assert details(project) == expected


@pytest.mark.parametrize("body", [
    "acc = data\n            for w in ws:\n                acc = acc @ w\n",
    "acc = data\n            for w in ws:\n                acc = torch.matmul(acc, w)\n",
    "acc = data\n            for w in ws:\n                acc = _mod2(acc, w)\n",
])
def test_window_program_staged_ladder_flagged(tmp_path, body):
    helper = "\n        def _mod2(a, b):\n            return (a @ b) % 2\n"
    project = skeleton_with(tmp_path, gcm=(
        "        def _process(data):\n" + PROCESS,
        "        def _process(data, ws=()):\n            " + body + PROCESS + helper,
    ))
    assert details(project) == ["interstage:staged-ladder"]


def test_sanctioned_ladder_and_plain_versions_not_flagged(tmp_path):
    ladder = ("        def _ghash_grouped(data, ladder=()):\n"
              "            for w in ladder:\n"
              "                data = data @ w\n"
              "            return data\n")
    plain = {GHASH: """
        def ghash_tree(data):
            if data.device.type == "cpu":
                return ghash_tree_plain(data)
            return data

        def ghash_tree_plain(data):
            acc = data
            for g in range(4):
                acc = int(acc @ data)
            return acc
    """}
    project = skeleton_with(tmp_path, extra=plain, gcm=(
        "        def _process(data):\n" + PROCESS,
        "        from tieredstorage_tpu_torch.ops.ghash_cuda import ghash_tree\n\n"
        "        def _process(data):\n            data = ghash_tree(data)\n"
        "            data = _ghash_grouped(data)\n" + PROCESS + ladder,
    ))
    window, _ = dispatch.build_closure(project, dispatch.WINDOW_CLOSURE_ROOTS,
                                       stop_at=frozenset(dispatch.PLAIN_VERSIONS))
    assert f"{GHASH}:ghash_tree_plain" in window and f"{GCM}:_ghash_grouped" in window
    assert details(project) == []


def test_host_tensor_helper_is_the_sanctioned_host_to_device_copy(tmp_path):
    helper = ("        def _host_tensor(array, dtype, device):\n"
              "            return torch.from_numpy(np.array(array, dtype=dtype)).to(device)\n")
    project = skeleton_with(tmp_path, gcm=(
        "        def _varlen_window(ctx, ivs, data_packed, lengths, *, decrypt, donate):\n",
        helper + "\n        def _varlen_window(ctx, ivs, data_packed, lengths, *, decrypt, donate):\n"
        "            ivs = _host_tensor(ivs, None, data_packed.device)\n",
    ))
    assert details(project) == []


# ------------------------------------------------------------ real tree
@pytest.fixture(scope="module")
def real_project():
    return load_project(REPO_ROOT)


def test_real_tree_is_clean(real_project):
    findings = run_analysis(real_project, only=["device-dispatch"]).findings
    assert findings == [], "\n".join(f.render() for f in findings)


def test_real_closure_spans_the_window_path(real_project):
    closure, _ = dispatch.build_closure(real_project)
    assert len(closure) > 50
    for key in (
        f"{CUDA}:CudaTransformBackend.transform_windows",
        f"{CUDA}:CudaTransformBackend._run_window",
        f"{CUDA}:CudaTransformBackend._stage_packed",
        f"{CUDA}:CudaTransformBackend._launch_packed",
        f"{CUDA}:CudaTransformBackend._build_packed",
        f"{GCM}:gcm_window_packed",
        f"{GCM}:gcm_varlen_window_packed",
        f"{GCM}:_gcm_varlen_batch",
        "tieredstorage_tpu_torch/ops/aes_bitsliced.py:ctr_keystream_batch",
        f"{GHASH}:ghash_tree",
        f"{GHASH}:ghash_level1",
        "tieredstorage_tpu_torch/ops/_cuda.py:launch",
        "tieredstorage_tpu_torch/parallel/mesh.py:run_on_members",
        "tieredstorage_tpu_torch/fetch/cache/device_hot.py:DeviceHotCache._serve_hot",
        "tieredstorage_tpu_torch/fetch/cache/device_hot.py:DeviceHotCache.device_rows",
        "tieredstorage_tpu_torch/transform/batcher.py:WindowBatcher._flush_group",
        "tieredstorage_tpu_torch/transform/batcher.py:WindowBatcher.submit_encrypt",
    ):
        assert key in closure, key


def test_real_window_closure_holds_the_kernels(real_project):
    skip = frozenset(dispatch.SANCTIONED_MATERIALIZERS) | dispatch.PLAIN_VERSIONS
    window, _ = dispatch.build_closure(real_project, dispatch.WINDOW_CLOSURE_ROOTS, stop_at=skip)
    for key in (f"{GCM}:_gcm_process_batch", f"{GCM}:_ghash_grouped",
                f"{GHASH}:ghash_tree", "tieredstorage_tpu_torch/ops/_cuda.py:launch"):
        assert key in window, key
    assert dispatch._launchers(real_project) == {"ctr_keystream_batch", "ghash_level1",
                                                  "ghash_tree"}


def test_codec_modules_stay_outside(real_project):
    closure, _ = dispatch.build_closure(real_project)
    assert not any("transform/thuff.py" in k or "transform/lzhuff.py" in k for k in closure)


def test_sanctioned_inventories_match_tree(real_project):
    """Every sanctioned entry names a function the closures reach, and
    carries its sentence: the inventories burn down with the code."""
    closure, _ = dispatch.build_closure(real_project)
    window, _ = dispatch.build_closure(real_project, dispatch.WINDOW_CLOSURE_ROOTS)
    for key, why in dispatch.SANCTIONED_MATERIALIZERS.items():
        assert key in closure or key in window, f"stale sanctioned entry {key}"
        assert len(why) >= 20
    for key in dispatch.PLAIN_VERSIONS | set(dispatch.SANCTIONED_STAGED_REDUCERS):
        assert key in window, f"stale window-closure entry {key}"


def test_staged_ladder_rule_engages_on_the_real_ladder(real_project, monkeypatch):
    """_ghash_grouped's torch ladder is a per-level loop on the window
    path; without its sanction the rule flags it."""
    monkeypatch.setattr(dispatch, "SANCTIONED_STAGED_REDUCERS", {})
    assert details(real_project) == ["interstage:staged-ladder"]


# ---------------------------------------------- seeded into the real code
def _real_copy(tmp_path):
    for rel in dispatch.HOT_PATH_MODULES:
        dest = tmp_path / rel
        dest.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(REPO_ROOT / rel, dest)
    return tmp_path


def _seed(tmp_path, rel, anchor, insert):
    root = _real_copy(tmp_path)
    path = root / rel
    src = path.read_text()
    assert src.count(anchor) == 1, anchor
    src = src.replace(anchor, anchor + insert)
    path.write_text(src)
    line = src[: src.index(insert)].count("\n") + 1
    report = run_analysis(load_project(root), only=["device-dispatch"])
    return report.findings, line


def test_real_copy_is_clean(tmp_path):
    root = _real_copy(tmp_path)
    assert run_analysis(load_project(root), only=["device-dispatch"]).findings == []


@pytest.mark.parametrize("name,rel,anchor,insert,detail,qualname", [
    ("item-in-launch-packed", CUDA,
     "        ready = None\n", "        _dbg = out.item()\n",
     "materialize:item", "CudaTransformBackend._launch_packed"),
    ("synchronize-in-stage-packed", CUDA,
     "        plan = self.mesh_plan()\n        rows = host.shape[0]\n",
     "        torch.cuda.synchronize()\n",
     "sync:torch.cuda.synchronize", "CudaTransformBackend._stage_packed"),
    ("staged-read-after-launch", CUDA,
     "        ready = None\n", "        _dbg = staged\n",
     "use-after-donate:staged", "CudaTransformBackend._launch_packed"),
    ("context-built-in-the-backend", CUDA,
     "        host = self._build_packed(payloads, sizes, ivs, n_bytes, varlen)\n",
     "        _dbg = gcm_ops.GcmContext(None, (), None, None, 0, 0)\n",
     "shape-not-bucketed:GcmContext", "CudaTransformBackend._run_window"),
])
def test_seeded_regression_is_flagged_at_its_line(tmp_path, name, rel, anchor, insert, detail,
                                                  qualname):
    findings, line = _seed(tmp_path, rel, anchor, insert)
    assert [(f.detail, f.qualname, f.line) for f in findings] == [(detail, qualname, line)]
