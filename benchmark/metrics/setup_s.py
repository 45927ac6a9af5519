"""Set-up seconds: from the process's start until the window opens
(imports, the card, kernel builds, weights, inputs, warm-up)."""

KIND = "end_to_end"
UNIT = "s"


def read(ctx):
    return ctx.get("setup_s")
