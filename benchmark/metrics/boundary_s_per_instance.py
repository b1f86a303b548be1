"""The contraction context and boundary stack's seconds per instance (the
program's stages "peps", where it has one, and "boundary"), summed over a
traced run's window."""


def read(run):
    st = run.stage_times
    if not st or not run.completed or "boundary" not in st:
        return None
    return (st.get("peps", 0.0) + st["boundary"]) / run.completed
