"""Film science of the plain reference: frozen copies of the port's
``film/{chain,loader,sensitometry,spectra,stock,transfer}.py`` and
``config.py``, with their imports renamed, the program's overlay of
user-imported stocks and the stock methods that reach modules not copied
left out. The reference builds its film parameters from these, so no change
to the program's film science can move what a frame is judged against."""
