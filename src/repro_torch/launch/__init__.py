"""Launch tools of the port: meshes, abstract input specs, the dry-run and the
training CLI (counterpart of ``repro.launch``)."""
