"""setup_s (s): from the start of the process to the start of the window:
imports, the traffic made on the card, the program built (its kernels
compiled on a checkout's first run) and every dispatch shape warmed."""


def read(ctx):
    return ctx.setup_s
