"""Quickstart: the accuracy-configurable sequential multiplier in 5 minutes.

Counterpart of ``examples/quickstart.py``, with ``--device``: it runs on
``cuda`` unless ``--device cpu`` is given (the plain PyTorch versions).

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import engine
from repro_torch.core import error_metrics, error_model, seqmul
from repro_torch.device import resolve_device

N, T = 8, 4  # 8-bit operands, carry chain split after bit 4


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    device = resolve_device(ap.parse_args(argv).device)

    # ---- 1. a single approximate product ----------------------------------
    a, b = (torch.tensor(v, dtype=torch.int64, device=device) for v in (183, 201))
    exact = int(a) * int(b)
    words = seqmul.seq_mul_words(a, b, n=N, t=T, approx=True)
    approx = int(seqmul.assemble_product_u64(words, n=N, t=T))
    print(f"{int(a)} x {int(b)} = {exact} (exact)  {approx} (segmented, t={T})  "
          f"ED={exact - approx}")

    # ---- 2. error metrics across the whole input space (paper Fig. 2) -----
    rep = error_metrics.exhaustive_eval(N, T, fix_to_1=False, device=device)
    print(rep.summary())
    print(f"closed-form MAE (Eq. 11) = {error_model.mae_closed_form(N, T)} "
          f"== measured worst overshoot {-rep.max_ed_neg}")

    # ---- 3. accuracy is configurable via the splitting point t ------------
    for t in (2, 4, 6):
        r = error_metrics.exhaustive_eval(N, t, device=device)
        print(f"  t={t}: ER={r.er:.3f} NMED={r.nmed:.2e}  "
              f"(latency ~ max(t, n-t) = {max(t, N - t)} FA delays)")

    # ---- 4. the multiplier as a GEMM inside a PyTorch model ---------------
    # repro_torch.engine is the one dispatch layer: pick a mode from the
    # registry, and the backend (reference bodies / CUDA kernels) follows
    # the tensors' device.
    print(f"engine modes: {engine.list_modes()}  backends: {list(engine.BACKENDS)}")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((32, 64)).astype(np.float32)).to(device)
    w = torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32)).to(device)
    y_exact = x @ w
    y_approx = engine.matmul(x, w, n=N, t=T, mode="bitexact")
    rel = float((y_approx - y_exact).abs().mean() / y_exact.abs().mean())
    print(f"approximate GEMM rel. error vs exact: {rel:.3%}")

    # ---- 5. the elementwise kernel path (the plain version on the CPU) ----
    am, bm = (torch.from_numpy(rng.integers(0, 1 << N, (8, 128)).astype(np.uint32)).to(device)
              for _ in range(2))
    prod = engine.multiply(am, bm, n=N, t=T)
    ref = engine.multiply(am, bm, n=N, t=T, backend="reference")
    same = bool(torch.equal(prod, ref))
    print(f"elementwise approximate products on {device.type}: shape={tuple(prod.shape)}, "
          f"dtype={prod.dtype}, bit-equal to the reference body={same}")


if __name__ == "__main__":
    main()
