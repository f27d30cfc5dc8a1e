"""The port's XML ParameterList reader and ProblemConfig.from_parameterlist
against the JAX package's (parelagmc_tpu/config.py:30-94, 374-439).

The reference's XML files are not in the repository, so the inputs are
written here in their layout: nested "Problem parameters", "Bayesian
inverse problem parameters" and "Preconditioner Library" sublists that
between them use every key from_parameterlist reads and every type
_parse_value parses. Each is read as a string and as a file, bare and
inside a wrapper element."""

import dataclasses
import xml.etree.ElementTree as ET

import pytest

import _torch_parity  # noqa: F401  (thread count)
from _torch_parity import port_config
from parelagmc_tpu import config as jconfig
from parelagmc_tpu_torch import config as tconfig

PROBLEM = """
  <ParameterList name="Problem parameters">
    <Parameter name="Correlation length" type="double" value="0.3"/>
    <Parameter name="Variance" type="double" value="0.5"/>
    <Parameter name="Lognormal" type="bool" value="false"/>
    <Parameter name="Sampler name" type="string" value="matern"/>
    <Parameter name="Number of modes" type="int" value="27"/>
    <Parameter name="Serial refinement levels" type="int" value="1"/>
    <Parameter name="Parallel refinement levels" type="int" value="2"/>
    <Parameter name="Unstructured coarsening" type="bool" value="true"/>
    <Parameter name="Coarsening factor" type="int" value="4"/>
    <Parameter name="Mean square error" type="double" value="2e-3"/>
    <Parameter name="MSE splitting ratio" type="double" value="0.25"/>
    <Parameter name="Number of samples" type="int" value="64"/>
    <Parameter name="Output filename for MC managers" type="string" value="run.dat"/>
    <Parameter name="Quantity of interest" type="string" value="local_avg_p"/>
    <Parameter name="Essential attributes" type="vector_int" value="1 0 1 0 1 0"/>
    <Parameter name="Observational attributes" type="vector(int)" value="0 1 0 0 0 0"/>
    <Parameter name="Inflow attributes" type="vector_int" value="0 0 0 0 0 1"/>
    <Parameter name="Local average pressure QoI spatial point" type="vector_double"
               value="0.25 0.5 0.75"/>
    <Parameter name="Epsilon for local average pressure QoI" type="float" value="0.05"/>
    <Parameter name="Verbosity" type="boolean" value="1"/>
  </ParameterList>"""

BAYES = """
  <ParameterList name="Bayesian inverse problem parameters">
    <Parameter name="Noise" type="double" value="0.09"/>
    <Parameter name="Number of observational data points" type="integer" value="2"/>
    <Parameter name="Epsilon for local average pressure" type="double" value="0.01"/>
    <Parameter name="Observational data coordinates" type="vector(double)"
               value="0.1 0.2 0.3 0.4 0.5 0.6"/>
    <Parameter name="Generate reference observational data" type="bool" value="yes"/>
    <Parameter name="Reference observational data filename" type="string" value="obs.dat"/>
  </ParameterList>"""

LIBRARY = """
  <ParameterList name="Preconditioner Library">
    <ParameterList name="MINRES-BJ-GS">
      <Parameter name="Type" type="string" value="Krylov"/>
      <ParameterList name="Solver Parameters">
        <Parameter name="Solver name" type="string" value="MINRES"/>
        <Parameter name="Maximum iterations" type="int" value="300"/>
        <Parameter name="Relative tolerance" type="double" value="1e-6"/>
        <Parameter name="Print final paragraph" type="bool" value="TRUE"/>
        <Parameter name="Levels" type="vector_string" value="fine coarse"/>
        <Parameter name="Teuchos array" type="Array(int)" value="{1, 2, 3}"/>
        <Parameter name="No type" value=" kept as a string "/>
      </ParameterList>
    </ParameterList>
  </ParameterList>"""

# Only the refinement split and the sampler name: the other keys keep their
# defaults and nlevels follows refinements.
SMALL = """
  <ParameterList name="Problem parameters">
    <Parameter name="Serial refinement levels" type="int" value="1"/>
  </ParameterList>"""


def _bare(*sublists):
    return '<ParameterList name="Master">' + "".join(sublists) + "\n</ParameterList>\n"


def _wrapped(*sublists):
    return '<?xml version="1.0"?>\n<ParameterListFile>\n' + _bare(*sublists) + "</ParameterListFile>\n"


DOCS = {
    "full-bare": _bare(PROBLEM, BAYES, LIBRARY),
    "full-wrapped": _wrapped(PROBLEM, BAYES, LIBRARY),
    "problem-only": _bare(PROBLEM),
    "bayes-only-wrapped": _wrapped(BAYES),
    "refinements-only": _bare(SMALL),
    "empty": _bare(),
}


def _source(tmp_path, name, as_file):
    text = DOCS[name]
    if not as_file:
        return text
    path = tmp_path / f"{name}.xml"
    path.write_text(text)
    return str(path)


@pytest.mark.parametrize("as_file", [False, True], ids=["string", "file"])
@pytest.mark.parametrize("name", list(DOCS))
def test_read_xml_parameterlist_matches_the_jax_package(tmp_path, name, as_file):
    """Both readers give equal nested dicts, of the same classes, and
    from_parameterlist gives configs equal field by field."""
    src = _source(tmp_path, name, as_file)
    mine, ref = tconfig.read_xml_parameterlist(src), jconfig.read_xml_parameterlist(src)
    assert mine == ref
    assert type(mine) is tconfig.ParameterList

    def classes(p):
        return {k: classes(v) if isinstance(v, dict) else type(v).__name__ for k, v in p.items()}

    assert classes(mine) == classes(ref)
    cfg, jcfg = tconfig.ProblemConfig.from_parameterlist(mine), \
        jconfig.ProblemConfig.from_parameterlist(ref)
    assert type(cfg) is tconfig.ProblemConfig
    assert dataclasses.asdict(cfg) == dataclasses.asdict(port_config(jcfg))
    assert cfg.nlevels == jcfg.nlevels


def test_every_key_and_type_is_read():
    """The full list sets every key from_parameterlist reads (each away from
    its default) and parses each type: int/integer, double/float,
    bool/boolean, string, the vector forms; a Teuchos Array(...) and an
    untyped value stay strings, in both packages alike."""
    plist = tconfig.read_xml_parameterlist(DOCS["full-bare"])
    cfg = tconfig.ProblemConfig.from_parameterlist(plist)
    default = tconfig.ProblemConfig()
    expect = dict(correlation_length=0.3, variance=0.5, lognormal=False, sampler_name="matern",
                  number_of_modes=27, refinements=3, nlevels=4, unstructured_coarsening=True,
                  coarsening_factor=4, mse=2e-3, mse_splitting_ratio=0.25, initial_samples=64,
                  output_filename="run.dat", qoi="local_avg_p", ess_attr=(1, 0, 1, 0, 1, 0),
                  obs_attr=(0, 1, 0, 0, 0, 0), inflow_attr=(0, 0, 0, 0, 0, 1),
                  qoi_point=(0.25, 0.5, 0.75), qoi_eps=0.05, verbose=True, bayes_noise=0.09,
                  bayes_num_obs=2, bayes_eps=0.01,
                  bayes_obs_coords=(0.1, 0.2, 0.3, 0.4, 0.5, 0.6),
                  bayes_generate_ref_data=True, bayes_ref_data_file="obs.dat")
    for k, v in expect.items():
        assert getattr(cfg, k) == v, k
        if k not in ("bayes_generate_ref_data", "inflow_attr"):
            assert getattr(default, k) != v, k
    solver = plist.sublist("Preconditioner Library", create=False).sublist(
        "MINRES-BJ-GS", create=False).sublist("Solver Parameters", create=False)
    assert solver["Solver name"] == "MINRES" and solver["Maximum iterations"] == 300
    assert solver["Print final paragraph"] is True
    assert solver["Levels"] == ["fine", "coarse"]
    assert solver["Teuchos array"] == "{1, 2, 3}"
    assert solver["No type"] == "kept as a string"
    assert solver.get("absent", 7) == 7
    with pytest.raises(KeyError):
        plist.sublist("No such list", create=False)
    assert plist.sublist("Created") == {} and "Created" in plist
    # The refinement sum clears nlevels, which then follows refinements.
    only = tconfig.ProblemConfig.from_parameterlist(
        tconfig.read_xml_parameterlist(DOCS["refinements-only"]))
    assert (only.refinements, only.nlevels) == (1, 2)


@pytest.mark.parametrize("type_str,value", [
    ("int", " 42 "), ("integer", "-3"), ("double", "1e-3"), ("float", "2.5"),
    ("bool", "True"), ("boolean", "0"), ("bool", "yes"), ("string", " x y "),
    ("vector_int", "1 2 3"), ("vector(double)", "0.5 1.5"), ("vector_string", "a b"),
    ("Array(int)", "{1, 2}"), ("Array(double)", "{0.5}"), ("anything", "v")])
def test_parse_value_matches_the_jax_package(type_str, value):
    got, ref = tconfig._parse_value(type_str, value), jconfig._parse_value(type_str, value)
    assert got == ref and type(got) is type(ref)


@pytest.mark.parametrize("text,error", [
    ("<ParameterList name='a'><Parameter name='x' type='int' value='1'>", ET.ParseError),
    ("not xml at all", ET.ParseError),
    ("/no/such/dir/list.xml", ET.ParseError),
    ("<ParameterList><Parameter type='int' value='1'/></ParameterList>", KeyError),
    ("<ParameterList><Parameter name='x' type='int' value='one'/></ParameterList>", ValueError),
    ("<ParameterList><Parameter name='x' type='double' value=''/></ParameterList>", ValueError),
])
def test_malformed_input_is_rejected_alike(text, error):
    """Unbalanced or non-XML text, a missing file (read as a string), a
    parameter without a name and an unparsable value raise the same error
    in both packages."""
    with pytest.raises(error) as mine:
        tconfig.read_xml_parameterlist(text)
    with pytest.raises(error) as ref:
        jconfig.read_xml_parameterlist(text)
    assert type(mine.value) is type(ref.value)
    assert str(mine.value) == str(ref.value)
