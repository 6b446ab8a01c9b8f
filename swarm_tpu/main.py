"""Entry point: parse args, read database, dispatch on resolution d.

Mirrors the reference main() (src/swarm.cc:633-675).
"""

import os
import sys

from .cli import (
    args_check,
    args_init,
    args_show,
    close_files,
    open_files,
)
from .db import db_read
from .fatal import FatalError
from .messages import HEADER_MESSAGE
from .params import Parameters, set_alignment_scoring_system
from .progress import Progress


def run(argv, progname: str) -> int:
    p = Parameters()
    p.logfile = sys.stderr
    used_options = args_init(argv, progname, p)
    set_alignment_scoring_system(p)
    args_check(used_options, p)
    open_files(p)
    p.logfile.write(HEADER_MESSAGE)
    args_show(p, p.logfile)

    progress = Progress(p.logfile, bool(p.opt_log))
    from . import metrics

    metrics.reset()

    # observability: SWARM_TPU_PROFILE_DIR captures a JAX profiler trace
    # of the whole run (the reference's PROFILE=1 build-mode analog);
    # SWARM_TPU_TIMING=1 prints per-phase wall times (progress.py)
    profile_dir = os.environ.get("SWARM_TPU_PROFILE_DIR")
    if profile_dir:
        import jax

        jax.profiler.start_trace(profile_dir)

    try:
        db = db_read(p, progress)

        if p.opt_differences == 0:
            from .models.derep import dereplicate

            dereplicate(p, db, progress)
        elif p.opt_differences == 1:
            from .models.d1 import algo_d1_run

            algo_d1_run(p, db, progress)
        else:
            from .models.general import algo_run

            algo_run(p, db, progress)
    finally:
        if profile_dir:
            import jax

            jax.profiler.stop_trace()

    close_files(p)
    from .progress import trace_dump

    trace_dump()
    metrics.dump()
    return 0


def main() -> int:
    progname = sys.argv[0]
    try:
        return run(sys.argv[1:], progname)
    except FatalError as exc:
        return 1
    except BrokenPipeError:
        os._exit(1)


if __name__ == "__main__":
    sys.exit(main())
