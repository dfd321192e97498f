"""The blind study (port of ``gui/``): its clip generation and its servers."""
