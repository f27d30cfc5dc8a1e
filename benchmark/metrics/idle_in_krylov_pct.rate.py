"""Device idle caused by issuing the Krylov loop, in %: of the profiled
window's device idle time, the share whose gaps' midpoints fall where the
host was inside a `krylov.iter` span and not in its `wait.krylov_test`
(profiler trace and the program's spans, programspans.py). Also prints
programspans.report on standard error, `# program spans: {...}`: the idle
split by innermost program span, and the program's Krylov iterations
beside the Recorder's."""

import json
import sys

import programspans


def read(run):
    print("# program spans: " + json.dumps(programspans.report(run)), file=sys.stderr)
    return programspans.idle_in_krylov_pct(run)
