"""upload_s: host clock around the program's upload (``to_device``: the
CSC and its layouts built, the copies to the device), ended by a device
synchronize."""


def read(run):
    return run.spans["upload_s"]
