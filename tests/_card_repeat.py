"""Run one card test of `tests/test_torch_kernel_cuda.py` N times in one
process and count its failures (for a test that failed once and has to
be reproduced):

    PYTHONPATH=src python tests/_card_repeat.py test_cuda_hot_swap_on_two_streams 50

Needs a CUDA card; imports no JAX (as the card tests)."""

import os
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

import test_torch_kernel_cuda as card  # noqa: E402


def main() -> int:
    name, n = sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else 50
    torch.backends.cuda.matmul.allow_tf32 = False  # the `cuda_device` fixture's setting
    test, device = getattr(card, name), torch.device("cuda")
    failures, t0 = [], time.perf_counter()
    for i in range(n):
        try:
            test(device)
        except Exception as e:  # counted and printed, the loop goes on
            failures.append((i, repr(e)[:300]))
            traceback.print_exc()
    print(f"{name}: {n} runs, {len(failures)} failed {failures} in "
          f"{time.perf_counter() - t0:.1f} s")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
