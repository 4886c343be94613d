"""The paper's own experiment configurations (§6 simulation setups).

A copy of ``repro.configs.ccp_paper`` built on the port's ScenarioConfig.
"""

from ..core.simulator import ScenarioConfig

ID = "ccp-paper"

# Fig. 3: a_n = 0.5, mu in {1,2,4}, 10-20 Mbps links, N=100.
FIG3 = {
    1: ScenarioConfig(N=100, scenario=1, mu_choices=(1.0, 2.0, 4.0),
                      a_mode="const", a_const=0.5),
    2: ScenarioConfig(N=100, scenario=2, mu_choices=(1.0, 2.0, 4.0),
                      a_mode="const", a_const=0.5),
}

# Fig. 4: a_n = 1/mu_n, mu in {1,3,9}.
FIG4 = {
    1: ScenarioConfig(N=100, scenario=1, mu_choices=(1.0, 3.0, 9.0),
                      a_mode="inv_mu"),
    2: ScenarioConfig(N=100, scenario=2, mu_choices=(1.0, 3.0, 9.0),
                      a_mode="inv_mu"),
}

# Fig. 5: N=10 helpers, slow links (0.1-0.2 Mbps), Scenario-2 runtimes.
FIG5 = ScenarioConfig(N=10, scenario=2, mu_choices=(1.0, 2.0, 4.0),
                      a_mode="const", a_const=0.5,
                      rate_lo=0.1e6, rate_hi=0.2e6)

# Efficiency table: R = 8000, Fig-4 helper distribution.
EFFICIENCY = FIG4[1]

R_SWEEP = (500, 1000, 2000, 4000, 6000, 8000, 10000)
REPS = 200
