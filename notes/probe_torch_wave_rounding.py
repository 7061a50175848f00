"""How torch's CUDA kernels round the ops of the wave's shading, on the card.

    python3 notes/probe_torch_wave_rounding.py

For kernels W1 and W3 (``brickmap_tpu_torch/csrc/wave.cu``) to equal their
plain torch versions bit for bit, each torch op they mirror must be known:
the order of a 3-wide ``.sum(1)`` (a [N, 3] row, a [3] vector), whether
``torch.linalg.cross`` fuses a multiply-add (and which), ``tensor / scalar``
(a product with the scalar's float reciprocal?), ``scalar / tensor``,
``x ** 2``/``** 1.5``/``** 5``, and whether torch's ``sin``/``cos``/``exp``/
``acos``/``sqrt`` equal the libdevice functions an nvcc build calls.  Prints
one line per op: the candidate forms and on how many of 1M inputs each
differs from torch's result (0 = that form is torch's).
"""

import ctypes
import os
import subprocess
import sys
import tempfile

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from brickmap_tpu_torch.kernels import build  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    tmp = tempfile.mkdtemp()
    so = os.path.join(tmp, "libcand.so")
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", so,
                    os.path.join(HERE, "probe_torch_wave_rounding.cu")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    p = ctypes.c_void_p
    lib.cand_launch.argtypes = [ctypes.c_int, p, p, p, p, p, p]
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    n = 1 << 20
    a = torch.randn((n, 3), generator=g, device=dev)
    b = torch.randn((n, 3), generator=g, device=dev)
    x = torch.rand((n,), generator=g, device=dev) * 4.0
    sums = torch.empty((n, 3), device=dev)
    cross = torch.empty((n, 3), device=dev)
    fns = torch.empty((n, 8), device=dev)
    assert lib.cand_launch(n, a.data_ptr(), b.data_ptr(), x.data_ptr(),
                           sums.data_ptr(), cross.data_ptr(),
                           fns.data_ptr()) == 0
    torch.cuda.synchronize()

    def report(name, got, cands):
        print(f"{name}: " + "; ".join(
            f"{k} {int((got != v).sum())}" for k, v in cands.items()),
            flush=True)

    orders = {"(a+b)+c": sums[:, 0], "(a+c)+b": sums[:, 1],
              "a+(b+c)": sums[:, 2]}
    report("(v*v).sum(1) [N,3]", (a * a).sum(1), orders)
    report("(v*v).sum(-1, keepdim) [N,3]", (a * a).sum(-1, keepdim=True)[:, 0],
           orders)
    vec = [(a[i] * a[i]).sum(-1, keepdim=True)[0] for i in range(256)]
    report("(v*v).sum(-1, keepdim) [3]", torch.stack(vec),
           {k: v[:256] for k, v in orders.items()})
    vec = [(a[i] * a[i]).sum() for i in range(256)]
    report("(v*v).sum() [3]", torch.stack(vec),
           {k: v[:256] for k, v in orders.items()})
    c = torch.linalg.cross(a, b)[:, 0]
    forms = {"fma(a1,b2,-(a2 b1))": cross[:, 0],
             "fma(-a2,b1,a1 b2)": cross[:, 1], "a1 b2 - a2 b1": cross[:, 2]}
    report("linalg.cross [N,3]", c, forms)
    ce = torch.linalg.cross(a[:1].expand(n, 3), b)[:, 0]
    a0 = a[:1].expand(n, 3)
    report("linalg.cross expanded a", ce, {
        "fma(a1,b2,-(a2 b1))": torch.from_numpy(
            (a0[:, 1].double() * b[:, 2].double()
             - (a0[:, 2] * b[:, 1]).double()).float().cpu().numpy()).to(dev),
        "a1 b2 - a2 b1": a0[:, 1] * b[:, 2] - a0[:, 2] * b[:, 1]})
    inv = torch.tensor(1.0, device=dev) / torch.tensor(1920.0, device=dev)
    report("x / 1920.0", x / 1920.0, {"x * (1f/1920f)": x * inv,
                                      "x / 1920f": x / torch.full_like(
                                          x, 1920.0)})
    report("8000.0 / x", 8000.0 / x, {
        "(1/x) * 8000f": torch.reciprocal(x) * 8000.0,
        "8000f / x": torch.full_like(x, 8000.0) / x})
    report("x ** 2", x ** 2, {"x*x": x * x})
    report("x ** 1.5", x ** 1.5, {"powf": fns[:, 4],
                                  "pow(tensor,tensor)": torch.pow(
                                      x, torch.full_like(x, 1.5))})
    y = x * 0.3
    report("y ** 5", y ** 5, {"powf": fns[:, 5],
                              "y*y*y*y*y": y * y * y * y * y})
    report("sin", torch.sin(x), {"sinf": fns[:, 0]})
    report("cos", torch.cos(x), {"cosf": fns[:, 1]})
    report("exp(-x)", torch.exp(-x), {"expf": fns[:, 2]})
    report("arccos", torch.arccos(x * 0.25 - 0.5), {"acosf": fns[:, 3]})
    report("sqrt", torch.sqrt(x), {"sqrtf": fns[:, 6]})
    report("reciprocal", torch.reciprocal(x), {"1/x": fns[:, 7]})
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
