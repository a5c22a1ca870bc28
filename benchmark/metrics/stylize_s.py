"""Seconds a job spends in the pipeline's ``stylize_latents``: the
harness's host span around the call, synchronised at its end, averaged
over the untraced window's jobs."""


def read(run):
    s = run.spans.get("stylize")
    return sum(s) / len(s) if s else None
