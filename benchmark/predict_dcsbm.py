"""The predict driver over a degree-corrected stand-in: writes the
configuration's ``dcsbm`` graph where the loader looks for it
(``standin_dcsbm.ensure``), then runs ``predict.run`` unchanged."""

from benchmark import predict, standin_dcsbm


def run(ctx: dict) -> dict:
    standin_dcsbm.ensure(ctx["cfg"], ctx["dirs"]["data"])
    return predict.run(ctx)
