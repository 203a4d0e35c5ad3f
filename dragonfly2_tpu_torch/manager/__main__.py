"""Run the port's manager with the flags of ``df manager``
(``cli/extra.add_manager_args``, the one definition of them).

    python -m dragonfly2_tpu_torch.manager --port 8080 --grpc-port 65003

It serves until SIGINT or SIGTERM. The default login is root/dragonfly.
"""

from __future__ import annotations

import argparse
import sys

from dragonfly2_tpu_torch.cli.extra import add_manager_args, run_manager


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m dragonfly2_tpu_torch.manager",
                                description=__doc__.split("\n\n")[0])
    add_manager_args(p)
    return run_manager(p.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
