"""The card's time of the supervised step's guard and AdamW (the program's
``sup.update`` device span) in the traced run's unprofiled stretch,
ms/step. None where the program has no such span."""


def read(ctx):
    spans = ctx.get("program", {}).get("spans", [])
    ms = [s["device_ms"] for s in spans
          if s["name"] == "sup.update" and s.get("device_ms") is not None]
    return sum(ms) / len(ms) if ms else None
