"""`python -m baryonyx_torch` — the CLI entry point (reference analogue:
app/src/main.cpp:1170)."""

from baryonyx_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
