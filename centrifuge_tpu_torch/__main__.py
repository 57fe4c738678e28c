"""Dispatch: python -m centrifuge_tpu_torch <tool> [args...]

Tools: classify (default), build, inspect, kreport, download, promote,
simulate, evaluate -- the JAX package's tool table, each tool a module of
the port's cli/. Only classify touches the card (on "cuda" unless
--device cpu).
"""

import importlib
import sys
from typing import List

_TOOLS = {
    "classify": ("centrifuge_tpu_torch.cli.classify", "run"),
    "build": ("centrifuge_tpu_torch.cli.build_cli", "run"),
    "inspect": ("centrifuge_tpu_torch.cli.inspect_cli", "run"),
    "kreport": ("centrifuge_tpu_torch.cli.kreport_cli", "run"),
    "download": ("centrifuge_tpu_torch.cli.download_cli", "run"),
    "promote": ("centrifuge_tpu_torch.cli.promote_cli", "run"),
    "simulate": ("centrifuge_tpu_torch.cli.eval_cli", "run_simulate"),
    "evaluate": ("centrifuge_tpu_torch.cli.eval_cli", "run_evaluate"),
}


def run(argv: List[str]) -> int:
    """Run the tool named by argv[0] (classify when argv[0] names none)
    on the rest of argv; returns its exit code."""
    tool = "classify"
    if argv and argv[0] in _TOOLS:
        tool, argv = argv[0], argv[1:]
    mod_name, fn = _TOOLS[tool]
    return getattr(importlib.import_module(mod_name), fn)(argv)


def main() -> None:
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
