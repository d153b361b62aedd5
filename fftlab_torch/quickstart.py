"""Quickstart menu of the port (counterpart of quickstart.py): the
`fftlab_torch.cli` demos, the minimal example and the port's tests, each
run on the card.

    python -m fftlab_torch.quickstart        # the menu
    python -m fftlab_torch.quickstart 1      # one entry
    python -m fftlab_torch.quickstart all    # every entry but the tests

The JAX menu's headline benchmark (bench.py) has no entry: the port has
no benchmark of its own yet.
"""

from __future__ import annotations

import subprocess
import sys

MENU = [
    ("Minimal 8-point FFT example", [sys.executable, "-m", "fftlab_torch.examples.minimal"]),
    ("Feature tour (planner, hardware, auto-selection)",
     [sys.executable, "-m", "fftlab_torch.cli.features"]),
    ("Cross-algorithm benchmark table",
     [sys.executable, "-m", "fftlab_torch.cli.benchmark", "--sizes", "64,256,1024"]),
    ("Streaming spectrum analyzer",
     [sys.executable, "-m", "fftlab_torch.cli.analyzer", "--frames", "3"]),
    ("Pitch detection / tuner", [sys.executable, "-m", "fftlab_torch.cli.pitch"]),
    ("FFT filtering", [sys.executable, "-m", "fftlab_torch.cli.filter"]),
    ("2D image FFT", [sys.executable, "-m", "fftlab_torch.cli.image"]),
    ("Power spectrum / Welch / coherence",
     [sys.executable, "-m", "fftlab_torch.cli.spectrum"]),
    ("Convolution (direct/FFT/overlap-save/overlap-add)",
     [sys.executable, "-m", "fftlab_torch.cli.convolution"]),
    ("Multi-device sharded pipeline demo",
     [sys.executable, "-m", "fftlab_torch.cli.dist_demo"]),
    ("Run the port's tests (the card tests need no JAX)",
     [sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider",
      "tests/test_torch_cuda.py", "-q"]),
]


def show_menu() -> None:
    print("=== fftlab_torch quickstart ===")
    for i, (name, _) in enumerate(MENU, 1):
        print(f"  {i:>2}. {name}")
    print("   0. exit")


def run(idx: int) -> int:
    name, cmd = MENU[idx - 1]
    print(f"\n--- {name} ---")
    return subprocess.call(cmd)


def main() -> None:
    if len(sys.argv) > 1:
        arg = sys.argv[1]
        if arg == "all":
            for i in range(1, len(MENU)):  # the tests only when asked for
                run(i)
            return
        try:
            idx = int(arg)
        except ValueError:
            print(__doc__.strip())
            show_menu()
            return
        if not 1 <= idx <= len(MENU):
            show_menu()
            return
        run(idx)
        return
    while True:
        show_menu()
        try:
            choice = input("choice> ").strip()
        except EOFError:
            return
        if choice in ("0", "q", ""):
            return
        try:
            idx = int(choice)
            if 1 <= idx <= len(MENU):
                run(idx)
        except ValueError:
            print(f"unknown choice {choice!r}")


if __name__ == "__main__":
    main()
