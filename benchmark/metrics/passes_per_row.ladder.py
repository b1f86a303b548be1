"""Variational passes per absorbed boundary row in the program's stage
"ladder": the counters ``#passes`` (passes of ``bmps._alternate``'s loop)
over ``#rows`` (rows absorbed by ``engine._build_stack``, the lanes
batched) of the stage's keys, over a traced run's window."""

STAGE = "ladder"


def _total(st, counter):
    return sum(v for k, v in st.items()
               if k.endswith("#" + counter)
               and k.split("#")[0].split("/")[0] == STAGE)


def read(run):
    st = run.stage_times
    if not st:
        return None
    rows = _total(st, "rows")
    return _total(st, "passes") / rows if rows else None
