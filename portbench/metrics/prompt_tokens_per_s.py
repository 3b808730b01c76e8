"""prompt_tokens_per_s (tokens/s, host clock): the unpadded prompt tokens of every
request completed in the window, over the window's whole time."""


def read(run):
    return sum(len(r.prompt) for r in run.requests()) / run.window_s
