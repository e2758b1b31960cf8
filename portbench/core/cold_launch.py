"""One cold CLI job in a process of its own:

    python -m portbench.core.cold_launch <module> <args...>

runs ``<module>.main(args)`` (the port's CLI, ``kmergutsjava_tpu_torch.cli``)
as ``python -m <module> <args...>`` would, then looks in this process's
``sys.modules`` for JAX or the JAX package (``forbidden.py``). Where it
finds one, it names it on standard error after ``MARK`` and exits with
``FOUND_EXIT``, whatever the job did."""
import importlib
import sys
import traceback

from portbench.core.forbidden import loaded

FOUND_EXIT = 86
MARK = "loaded in the job's process:"


def main(argv) -> int:
    module, args = argv[0], argv[1:]
    sys.argv = [module, *args]
    try:
        code = importlib.import_module(module).main(args)
    except SystemExit as ex:
        code = ex.code
    except Exception:  # the job failed; its modules are still looked at
        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    found = loaded()
    if found:
        print(f"{MARK} {', '.join(found)}", file=sys.stderr, flush=True)
        return FOUND_EXIT
    return code


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
