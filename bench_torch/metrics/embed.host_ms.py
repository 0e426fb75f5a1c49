"""The server's host time per request in reading it off the socket,
dispatching it (pad, copy, launch the forward) and sending the reply; the
wait for the card (collect) is left out, ms."""


def read(ctx):
    s, n = ctx["spans"], ctx["counters"].get("requests", 0)
    if not n:
        return None
    return 1e3 * sum(sum(s.get(k, [])) for k in ("read", "dispatch", "send")) / n
