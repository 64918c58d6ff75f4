"""Package dispatcher: python -m dexiraft_tpu_torch
{serve,router,train,eval,viz,dexined,pack_records} [args...]

The port's counterpart of ``python -m dexiraft_tpu``.
"""

import importlib
import sys

_COMMANDS = {
    "serve": "dexiraft_tpu_torch.serve_cli",
    "router": "dexiraft_tpu_torch.router_cli",
    "train": "dexiraft_tpu_torch.train_cli",
    "eval": "dexiraft_tpu_torch.eval_cli",
    "viz": "dexiraft_tpu_torch.viz_cli",
    "dexined": "dexiraft_tpu_torch.dexined_cli",
    "pack_records": "dexiraft_tpu_torch.pack_records",
}


def main() -> None:
    if len(sys.argv) < 2 or sys.argv[1] not in _COMMANDS:
        print(f"usage: python -m dexiraft_tpu_torch "
              f"{{{','.join(_COMMANDS)}}} [args...]", file=sys.stderr)
        raise SystemExit(2)
    # a command's integer return is the exit code (pack_records --verify)
    sys.exit(importlib.import_module(_COMMANDS[sys.argv[1]]).main(
        sys.argv[2:]))


if __name__ == "__main__":
    main()
