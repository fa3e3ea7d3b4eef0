"""Host milliseconds a batch spends in the service's own work: the
program's `service.collect` (the worker's lock, linger wait and take),
`service.noise` (the host's noise draws and their copy to the card) and
`service.reply` (the uint8 copy-out and the answers) spans, the mean over
the batches of the traced run's window outside the profile and its
read-out.  A batch's collect is the one its worker closed between the
previous batch and this one, from no earlier than the window's opening; a
batch without one (the window's first, whose collect opened before the
program's spans were enabled) is left out."""

from benchmark.metrics import _program

_program.install()


def worker_spans(run):
    """[(batch start ns, batch end ns, {name: [(start ns, end ns)]})] for
    each batch outside the profile, with the worker's program spans that
    lie inside the batch or, for `service.collect`, end before it and after
    the previous batch; None without a traced window or program spans."""
    s, rec = run.session, _program.recorder(run)
    if rec is None:
        return None
    worker = s.svc._worker_thread.ident
    mine = sorted((t0, t1, name) for name, tid, t0, t1, _ in rec.spans if tid == worker)
    if not mine:
        return None
    out, prev = [], int(run.window.opened * 1e9)
    for b0, b1, _ in s.batch_log:
        b0, b1 = int(b0 * 1e9), int(b1 * 1e9)
        if b1 > s.paused and b0 < s.resumed:
            prev = b1
            continue
        inside = {}
        for t0, t1, name in mine:
            if name == "service.collect" and prev <= t1 <= b0:
                inside[name] = [(max(t0, prev), t1)]
            elif b0 <= t0 and t1 <= b1:
                inside.setdefault(name, []).append((t0, t1))
        out.append((b0, b1, inside))
        prev = b1
    return out


def read(run):
    batches = worker_spans(run)
    if not batches:
        return None
    names = ("service.collect", "service.noise", "service.reply")
    per = [sum(t1 - t0 for n in names for t0, t1 in inside.get(n, ())) for _, _, inside in batches
           if "service.collect" in inside and "service.noise" in inside]
    return sum(per) / len(per) / 1e6 if per else None
