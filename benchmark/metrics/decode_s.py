"""Seconds a job spends decoding its stylized latents to uint8 frames and
copying them to the host: the harness's host span around the call,
averaged over the untraced window's jobs."""


def read(run):
    s = run.spans.get("decode")
    return sum(s) / len(s) if s else None
