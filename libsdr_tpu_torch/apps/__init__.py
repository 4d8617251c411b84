"""Application CLIs (counterparts of ``libsdr_tpu.apps``): the analog
receivers, the WAV play-through, the digital receivers (POCSAG, AX.25/APRS,
RTTY) and the signal generator.  Input is a WAV or raw IQ capture; output a
WAV file or decoded messages.  Run as modules, e.g.::

    python -m libsdr_tpu_torch.apps.rx --file capture.wav -m USB -o out.wav
    python -m libsdr_tpu_torch.apps.fm_rx --file capture.wav -o audio.wav
    python -m libsdr_tpu_torch.apps.tx pocsag -o page.wav --text "PAGE ME"
    python -m libsdr_tpu_torch.apps.pocsag_rx --file page.wav

``--device`` picks where the receivers process their blocks (default
``cuda``; ``cpu`` runs the plain PyTorch versions).
"""
