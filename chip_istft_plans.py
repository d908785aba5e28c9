"""K5 istft's plans by n_fft: the timings that set its rule's threshold.

`csrc/istft.cu` takes its direct plan (a DFT compiled for the size, a
thread a frame) at n_fft 16 and 32 and the shared-memory FFT core from 64.
This script times `mel.istft` at n_fft 16, 32, 64 and 128 (hop n_fft / 2,
B = 4, 2^20 / n_fft + 1 frames an item: ~2.1 M samples, iSTFTNet's batch
request's count) on standard normal spectra, in the plan the rule picks;
then at 16 and 32 once more through the source built with 64 KB of shared
memory a block (`-DSMEM_MAX=65536`, into `build/probe/`), where the direct
plan does not fit and the rule picks the FFT plan. Each output is held
within 1e-5 of each sample's own scale (`chip_smoke.istft_scale`) against
the plain version; times are device time (`chip_smoke.device_ms`). Prints
the card's name and power limit and one JSON line; exit code 1 where an
output does not hold.

    python3 chip_istft_plans.py

Needs one CUDA card and `nvcc`.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_istft_plans: no CUDA device", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from fish_diffusion_tpu_torch import kernels
    from fish_diffusion_tpu_torch.ops import mel

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    default = kernels.load_library("istft")
    out = root / "build" / "probe" / "libistft-smem65536.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-DSMEM_MAX=65536", "-o", str(out),
                    str(kernels.CSRC / "istft.cu")], check=True, capture_output=True)
    small = ctypes.CDLL(str(out))
    for fn, argtypes in kernels.SIGNATURES["istft"].items():
        getattr(small, fn).argtypes = argtypes
        getattr(small, fn).restype = ctypes.c_int

    gen = torch.Generator(device="cuda").manual_seed(71)
    rows, differs = {}, []
    for n_fft in (16, 32, 64, 128):
        hop, frames = n_fft // 2, (1 << 20) // n_fft + 1
        spec = [torch.randn((4, n_fft // 2 + 1, frames), generator=gen, device="cuda")
                for _ in range(2)]
        scale = cs.istft_scale(*spec, n_fft, hop)
        ref = mel.istft_reference(*spec, n_fft, hop)
        for lib in (default, small) if n_fft <= 32 else (default,):
            kernels._LIBS["istft"] = lib
            mel.istft_plan.cache_clear()
            plan = mel.istft_plan(n_fft, hop, frames)
            run = lambda: mel.istft(*spec, n_fft, hop)  # noqa: E731
            holds = bool(((run() - ref).abs() <= 1e-5 * scale).all())
            ms = cs.device_ms(run)
            rows[f"n_fft {n_fft} {plan}"] = dict(ms=ms, holds=holds,
                                                 rule=lib is default)
            print(f"n_fft {n_fft}, hop {hop}, B=4 x {frames} frames, {plan} plan"
                  f"{'' if lib is default else ' (built with -DSMEM_MAX=65536)'}: "
                  f"{ms:.4f} ms of device time; holds against plain: {holds}")
            if not holds:
                differs.append(f"n_fft {n_fft} {plan}")
        del spec, scale, ref
    kernels._LIBS["istft"] = default
    mel.istft_plan.cache_clear()
    print(json.dumps({"card": smi, "plans": rows, "differs": differs}))
    return 1 if differs else 0


if __name__ == "__main__":
    sys.exit(main())
