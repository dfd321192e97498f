"""The blind study's clip generation (port of the device paths of ``gui/``)."""
