"""Multichip demo of the PyTorch/CUDA port: the split transform path as a
gate.

Counterpart of tools/multichip_demo.py over `tieredstorage_tpu_torch`: a
thin wrapper over the port's production-path drill
(`tieredstorage_tpu_torch/parallel/multichip.py`) at 8 members and the JAX
gate's shapes (32 KiB chunks, 24-row fixed window). With `--device cpu` the
8 members are virtual CPU members through the port's pin
(`utils/platforms.pin_virtual_cpu`, the counterpart of the JAX gate's
8-device virtual CPU mesh); on `cuda:0` they are every GPU when the host
has 8, else 8 members that repeat `cuda:0` (each on its own stream), as
chip_smoke.py's mesh phase splits one card. The drill asserts:

- split output byte-identical to unsplit for fixed and varlen windows,
  encrypt and decrypt;
- one logical dispatch / staging transfer / fetch per window with
  `mesh_size = 8`, every staged buffer reused for its output;
- non-divisible batches pad on the device and the padding never reaches
  the wire;
- the chunk-index collective agrees with the host-side transformed sizes.

    python3 tools/torch_multichip_demo.py --out artifacts/torch_multichip_report.json
    python3 tools/torch_multichip_demo.py --device cpu

Without CUDA, and without `--device cpu`, it exits 2 and runs nothing.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO_ROOT))

import torch  # noqa: E402

N_DEVICES = 8
CHUNK_BYTES = 32 << 10
WINDOW = 24  # 3 rows per member on the fixed window


def _plan(device: str):
    """The drill's 8 members on `device` (None: the pinned CPU members)."""
    from tieredstorage_tpu_torch.parallel.mesh import MeshPlan
    from tieredstorage_tpu_torch.utils.platforms import pin_virtual_cpu

    if torch.device(device).type == "cpu":
        pin_virtual_cpu(N_DEVICES)
        return None
    if torch.cuda.device_count() >= N_DEVICES:
        return MeshPlan.from_spec(N_DEVICES)
    return MeshPlan.wrap([device] * N_DEVICES)


def run(out_path: pathlib.Path, device: str = "cuda:0") -> int:
    from tieredstorage_tpu_torch.parallel.multichip import run_drill, summary_line

    t0 = time.perf_counter()
    report = run_drill(N_DEVICES, chunk_bytes=CHUNK_BYTES, window=WINDOW, plan=_plan(device))
    report["elapsed_ms"] = round((time.perf_counter() - t0) * 1e3, 1)
    report["device"] = device

    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(report, indent=1, sort_keys=True, default=str) + "\n")

    # Re-read and validate the artifact, like the other demo gates.
    loaded = json.loads(out_path.read_text())
    for section in ("fixed", "varlen"):
        for name, ok in sorted(loaded[section]["checks"].items()):
            print(f"[torch-multichip-demo] {section}.{name}: {'PASS' if ok else 'FAIL'}")
    if "host_oracle_skipped" in loaded:
        print(
            "[torch-multichip-demo] host oracle skipped (cryptography not "
            f"installed): {loaded['host_oracle_skipped']}"
        )
    print(summary_line(loaded))
    print(
        f"[torch-multichip-demo] mesh_size={loaded['fixed']['mesh_size']} "
        f"rows_per_device={loaded['fixed']['rows_per_device']} "
        f"dispatches_per_window={loaded['fixed']['dispatches_per_window']} "
        f"in {loaded['elapsed_ms']} ms -> {out_path}"
    )
    ok = bool(loaded["ok"]) and loaded["fixed"]["mesh_size"] == N_DEVICES
    return 0 if ok else 1


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--out",
        type=pathlib.Path,
        default=REPO_ROOT / "artifacts" / "torch_multichip_report.json",
    )
    parser.add_argument("--device", default="cuda:0",
                        help="cuda:N (default cuda:0) or cpu for virtual CPU members")
    args = parser.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("torch_multichip_demo: CUDA is not available; pass --device cpu to run "
              "the drill on virtual CPU members", file=sys.stderr)
        return 2
    return run(args.out, args.device)


if __name__ == "__main__":
    sys.exit(main())
