"""The paper-figure scripts of the port: Figs. 3, 4 and 5 and the §6
efficiency table, through :class:`repro_torch.core.engine.Engine`.

    PYTHONPATH=src python -m repro_torch.figures.run              # on the card
    PYTHONPATH=src python -m repro_torch.figures.run --smoke --device cpu

The port's counterpart of the reference's ``benchmarks/{fig3,fig4,fig5,
efficiency}.py``: the same rows, summaries and default sweeps, written as
``{"meta", "data"}`` JSON to ``build/repro_torch/figures/`` (``--out``).
"""
