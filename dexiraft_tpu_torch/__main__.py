"""Package dispatcher: python -m dexiraft_tpu_torch {serve,train} [args...]

The port's counterpart of ``python -m dexiraft_tpu``; the other commands
(eval, router, dexined, viz) come with their ROADMAP items.
"""

import sys


def main() -> None:
    cmds = ("serve", "train")
    if len(sys.argv) < 2 or sys.argv[1] not in cmds:
        print(f"usage: python -m dexiraft_tpu_torch {{{','.join(cmds)}}} "
              "[args...]", file=sys.stderr)
        raise SystemExit(2)
    if sys.argv[1] == "serve":
        from dexiraft_tpu_torch.serve_cli import main as run
    else:
        from dexiraft_tpu_torch.train_cli import main as run
    run(sys.argv[2:])


if __name__ == "__main__":
    main()
