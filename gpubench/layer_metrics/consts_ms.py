"""Host constants: milliseconds of building the cell's pricer (the fGN
factor on the host, its copy to the device, the kernel family's
constants), on the host's clock."""


def read(run):
    return 1e3 * run.consts_s
