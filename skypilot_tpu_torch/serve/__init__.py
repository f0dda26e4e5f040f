"""The port's serving data plane: the load balancer on the standard
library (`load_balancer.py`), its routing policies
(`load_balancing_policies.py`), the `service:` spec (`service_spec.py`)
and the autoscalers (`autoscalers.py`), each beside its counterpart in
`skypilot_tpu/serve/`. The LB is entered as the reference's serve
controller enters it: `LoadBalancer(policy, port, now_fn)`, `start()`,
`set_replicas(urls, pools)`, `tracker.qps()`, `stop()`.
"""
