"""End to end: seconds from the process's start to the window's."""


def read(info):
    return info.setup_s
