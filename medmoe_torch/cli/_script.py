"""Console-script adapters for the port's ``[project.scripts]`` entries
(``medmoe-torch-*``; counterpart of medmoe_tpu/cli/_script.py).

setuptools wraps an entry point as ``sys.exit(fn())``. The CLI ``main()``
functions return metrics dicts (they double as the library surface), and
``sys.exit(<non-empty dict>)`` prints the dict and exits with status 1, so
``medmoe-torch-eval ... && next`` would stop the chain. These adapters map
any non-int return to status 0 and pass int statuses (serve's) through.
"""

from __future__ import annotations

from typing import Any


def _as_status(ret: Any) -> int:
    return ret if isinstance(ret, int) else 0


def train() -> int:
    from medmoe_torch.cli.train import main

    return _as_status(main())


def evaluate() -> int:
    from medmoe_torch.cli.eval import main

    return _as_status(main())


def eval_zs() -> int:
    from medmoe_torch.cli.eval_zs import main

    return _as_status(main())


def serve() -> int:
    from medmoe_torch.cli.serve import main

    return _as_status(main())


def export() -> int:
    from medmoe_torch.cli.export import main

    return _as_status(main())
