"""Expected squared jump a second: the mean squared jump of a chain
iteration over every trajectory coordinate and chain (the loop's
`OnlineStats.ejsd`, over the window's sampled steps), times the chain
iterations a second."""


def read(ctx):
    return float(ctx["stats"].ejsd.double().mean()) * ctx["chains"] * ctx["steps"] \
        / ctx["window_s"]
