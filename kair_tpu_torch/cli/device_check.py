"""Environment check (counterpart of ``kair_tpu/cli/device_check.py``;
reference testcuda.py:1-37): torch and CUDA versions, the devices, a
128×128 round trip that must come back bit for bit, a matmul's sum, and
the mesh ``parallel.mesh.make_mesh`` would build.

    python -m kair_tpu_torch.cli.device_check [--device cpu]
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    import numpy as np
    import torch

    from kair_tpu_torch import default_device
    from kair_tpu_torch.parallel.mesh import make_mesh

    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    dev = default_device(parser.parse_args(argv).device)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        print(f"devices ({n}):")
        for i in range(n):
            print(f"  [{i}] {torch.cuda.get_device_name(i)}")
    else:
        print("devices (1):\n  [0] cpu")

    x = np.random.RandomState(0).rand(128, 128).astype(np.float32)
    dx = torch.from_numpy(x).to(dev)
    if not np.array_equal(dx.cpu().numpy(), x):
        raise RuntimeError("device round trip corrupted data")
    print("tensor round-trip: OK")
    y = (dx @ dx.T).sum()
    print(f"matmul on {dev.type}: {float(y):.3f}")
    print(f"mesh: {make_mesh().shape}")
    print("OK")


if __name__ == "__main__":
    main()
