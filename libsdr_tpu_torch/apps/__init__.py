"""Application CLIs (counterparts of ``libsdr_tpu.apps``): the analog
receivers and the WAV play-through.  Input is a WAV or raw IQ capture,
output a WAV file.  Run as modules, e.g.::

    python -m libsdr_tpu_torch.apps.rx --file capture.wav -m USB -o out.wav
    python -m libsdr_tpu_torch.apps.fm_rx --file capture.wav -o audio.wav

``--device`` picks where the blocks are processed (default ``cuda``;
``cpu`` runs the plain PyTorch versions).
"""
